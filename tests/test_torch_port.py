"""Package-level properties of the PyTorch port (singa_tpu_torch):

  - its copies of the JAX package's framework-free modules (serve/,
    config/, data/records.py, data/shard.py, graph/kahn.py,
    utils/timers.py) keep the originals' code, and the allocator copy
    behaves like the original;
  - the serve_bench tool runs on the CPU when asked;
  - nothing of it (nor chip_smoke.py) imports jax or singa_tpu;
  - its entry points run on the GPU unless the CPU is asked for, and
    raise without one;
  - the CUDA build starts only when a kernel is first used.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import singa_tpu.config as j_config
import singa_tpu.graph as j_graph
import singa_tpu_torch.config as t_config
import singa_tpu_torch.graph as t_graph
from singa_tpu.config import schema as j_schema
from singa_tpu.config import textproto as j_textproto
from singa_tpu.data import records as j_records
from singa_tpu.data import shard as j_shard
from singa_tpu.graph import kahn as j_kahn
from singa_tpu.serve import kv_pool as j_kv_pool
from singa_tpu.serve import speculate as j_speculate
from singa_tpu.utils import timers as j_timers
from singa_tpu_torch import _build
from singa_tpu_torch.config import schema as t_schema
from singa_tpu_torch.config import textproto as t_textproto
from singa_tpu_torch.data import records as t_records
from singa_tpu_torch.data import shard as t_shard
from singa_tpu_torch.graph import kahn as t_kahn
from singa_tpu_torch.serve import kv_pool as t_kv_pool
from singa_tpu_torch.serve import speculate as t_speculate
from singa_tpu_torch.tools import serve_bench
from singa_tpu_torch.utils import timers as t_timers

REPO = pathlib.Path(__file__).resolve().parent.parent


def _body_without_docstring(path, free=()):
    """The module's top-level AST without its docstring, and without the
    docstrings of the top-level classes or functions named in ``free``."""
    body = ast.parse(pathlib.Path(path).read_text()).body
    if isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                    ast.Constant):
        body = body[1:]
    for node in body:
        if getattr(node, "name", None) in free:
            assert ast.get_docstring(node) is not None, node.name
            node.body = node.body[1:]
    return [ast.dump(node) for node in body]


#: the one copy with a docstring beside its module's that differs:
#: KernelsConfig's names a change in the original's history by its
#: number, and the copy words that sentence without it
FREE_DOCSTRINGS = {t_schema: ("KernelsConfig",)}


@pytest.mark.parametrize("orig,copy", [
    (j_kv_pool, t_kv_pool),
    (j_speculate, t_speculate),
    (j_config, t_config),
    (j_schema, t_schema),
    (j_textproto, t_textproto),
    (j_records, t_records),
    (j_shard, t_shard),
    (j_graph, t_graph),
    (j_kahn, t_kahn),
    (j_timers, t_timers),
])
def test_copies_keep_the_originals_code(orig, copy):
    """Only the module docstring (and the docstrings named in
    FREE_DOCSTRINGS) may differ: a fix to the original must be carried to
    the copy."""
    free = FREE_DOCSTRINGS.get(copy, ())
    assert _body_without_docstring(copy.__file__, free) == \
        _body_without_docstring(orig.__file__, free)


def _drive_allocator(mod, seed):
    """A seeded run of admissions, prefix registrations and releases ->
    the trace of every observable outcome."""
    rs = np.random.RandomState(seed)
    pool = mod.KVPool.for_model(32, 4, 12, 2)
    alloc = mod.BlockAllocator(pool, prefix_cache=True, tail_stride=2)
    owned, trace = [], []
    for _ in range(60):
        if owned and rs.rand() < 0.4:
            blocks, tokens = owned.pop(rs.randint(len(owned)))
            alloc.release(blocks)
            trace.append(("release", alloc.free_blocks, alloc.cached_blocks))
            continue
        tokens = rs.randint(0, 2, size=(int(rs.randint(1, 14)),))
        chain = alloc.cache.chain(tokens)
        hit = alloc.cache.match_chain(chain)
        need = pool.blocks_for(len(tokens)) - len(hit)
        if need > alloc.headroom_excluding(hit):
            # the engine's admission order: feasibility first, then
            # retain the hit, then allocate the rest
            with pytest.raises(mod.PoolExhausted):
                alloc.alloc(alloc.free_blocks + 1)
            trace.append(("exhausted", need))
            continue
        if hit:
            alloc.retain(hit)
        blocks = hit + alloc.alloc(need)
        for i, d in enumerate(chain[len(hit):], start=len(hit)):
            alloc.cache.register(d, blocks[i],
                                 parent=chain[i - 1] if i else None)
        alloc.cache.register_tail(tokens, blocks[-1])
        owned.append((blocks, tokens))
        trace.append(("alloc", tuple(blocks), alloc.free_blocks,
                      alloc.lru_evictions, len(alloc.cache)))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_pool_copy_behaves_like_the_original(seed):
    assert _drive_allocator(t_kv_pool, seed) == \
        _drive_allocator(j_kv_pool, seed)


def test_kv_pool_geometry_errors_match():
    for args in [(64, 0), (64, 5), (64, 16, 3)]:
        for mod in (j_kv_pool, t_kv_pool):
            with pytest.raises(ValueError):
                mod.KVPool.for_model(*args)


def test_drafters_match_the_originals():
    rs = np.random.RandomState(0)
    for _ in range(50):
        ctx = list(rs.randint(0, 4, size=(int(rs.randint(0, 20)),)))
        k = int(rs.randint(0, 6))
        assert t_speculate.NGramDrafter().draft(ctx, k) == \
            j_speculate.NGramDrafter().draft(ctx, k)
        assert t_speculate.make_drafter("null").draft(ctx, k) == []
    with pytest.raises(ValueError):
        t_speculate.make_drafter("model")


@pytest.mark.parametrize("extra", [
    [],
    ["--speculate_k", "3", "--workload", "repeat"],
    ["--kernels", "reference"],
])
def test_serve_bench_runs_on_the_cpu(capsys, extra):
    rc = serve_bench.main([
        "--device", "cpu", "--requests", "4", "--concurrency", "2",
        "--d_model", "32", "--n_heads", "2", "--d_ff", "64", "--vocab",
        "64", "--max_len", "48", "--prompt_len", "8", "--max_new", "8",
        "--block_len", "8", "--prefill_chunk", "4", "--no_gate", *extra,
    ])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["device"] == "cpu"
    assert out["token_mismatches"] == 0
    assert out["finished"] == 4 and out["tokens"] == 32
    for key in ("tokens_per_s", "p50_ms", "p99_ms", "speedup"):
        assert key in out


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "singa_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import singa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    singa_tpu_torch.__path__, "singa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "singa_tpu")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_singa_tpu():
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(REPO)],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 35


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_gpu):
    from singa_tpu_torch.device import resolve_device
    from singa_tpu_torch.models.transformer import (
        TransformerConfig,
        init_lm,
        load_jax_params,
    )
    from singa_tpu_torch.config import parse_model_config
    from singa_tpu_torch.main import main as train_main
    from singa_tpu_torch.serve import Engine
    from singa_tpu_torch.trainer import Trainer

    conf = str(REPO / "examples" / "lm" / "tinylm_longctx_d128.conf")
    cfg = TransformerConfig(vocab=16, d_model=32, n_heads=2, max_len=16)
    calls = [
        lambda: resolve_device(),
        lambda: init_lm(torch.Generator(), cfg),
        lambda: load_jax_params({"w": np.zeros(2, np.float32)}),
        lambda: serve_bench.main(["--requests", "1"]),
        lambda: Trainer(parse_model_config("")),
        lambda: train_main(["-model_conf", conf]),
    ]
    params = init_lm(torch.Generator(), cfg, "cpu")
    calls.append(lambda: Engine(params, cfg))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_kernel_build_needs_nvcc_and_starts_only_on_use(monkeypatch,
                                                        tmp_path):
    assert _build.sources() == ["flash_attention", "flash_attention_bf16",
                                "paged_attention", "quant_acc"]
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load.__wrapped__("paged_attention")
