"""The port's source rules (``singa_tpu_torch/lint/ast_rules.py``): each
fires on a planted file and is silenced by its ``# netlint: disable``
suppression; ``--self`` reports nothing over ``singa_tpu_torch/``, and
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` lint clean. The JAX
family (JAX000-005) has no counterpart: the port has no ``jax.jit``.
"""

import json
import pathlib
import textwrap

import pytest

from singa_tpu_torch.lint import Collector, lint_python_file
from singa_tpu_torch.lint.ast_rules import lint_python_tree
from singa_tpu_torch.tools import lint as t_cli

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "singa_tpu_torch"


def lint_source(tmp_path, source, name="mod.py", package=None):
    """Lint ``source`` written as ``name`` (inside a package directory
    ``package`` when given) -> {code: [line, ...]}."""
    d = tmp_path
    if package:
        d = tmp_path / package
        d.mkdir(exist_ok=True)
        (d / "__init__.py").write_text("")
    p = d / name
    p.write_text(textwrap.dedent(source))
    col = Collector()
    lint_python_file(str(p), col)
    out = {}
    for diag in col.sorted():
        out.setdefault(diag.code, []).append(int(diag.loc.split(":")[-2]))
    return {code: sorted(lines) for code, lines in out.items()}


# ---------------------------------------------------------------------------
# PRT001: the port imports neither jax nor the JAX package
# ---------------------------------------------------------------------------


FORBIDDEN = ["import jax", "import jax.numpy as jnp", "from jax import lax",
             "import singa_tpu", "from singa_tpu.config import schema"]
ALLOWED = ["from .config import schema", "import singa_tpu_torch.config",
           "import jaxtyping"]


@pytest.mark.parametrize("lines, fires", [(FORBIDDEN, True),
                                          (ALLOWED, False)],
                         ids=["forbidden", "allowed"])
def test_prt001_fires_in_the_port_package(tmp_path, lines, fires):
    """Each import inside a function of a port module; the same lines
    outside the port (a test, say) are fine."""
    src = "".join(f"def f{i}():\n    {line}\n"
                  for i, line in enumerate(lines))
    got = lint_source(tmp_path, src, package="singa_tpu_torch")
    want = [2 * i + 2 for i in range(len(lines))]
    assert got == ({"PRT001": want} if fires else {})
    assert lint_source(tmp_path, src, name="test_x.py") == {}


def test_prt001_covers_chip_smoke_and_its_suppression(tmp_path):
    src = "import jax\nimport singa_tpu  # netlint: disable=PRT001\n"
    assert lint_source(tmp_path, src, name="chip_smoke.py") == {
        "PRT001": [1]}
    # a checkout whose directory is named like the package is not the
    # package: only a file inside its __init__.py tree counts
    d = tmp_path / "singa_tpu_torch"
    d.mkdir()
    assert lint_source(d, src, name="loose.py") == {}


# ---------------------------------------------------------------------------
# PRT002: no host sync in a body handed to Graphed
# ---------------------------------------------------------------------------


GRAPHED = """
import functools
import torch
from singa_tpu_torch.utils.graphs import Graphed


class Step:
    def __init__(self, dev):
        self.g = Graphed(self._body, dev)
        self.e = Graphed(functools.partial(self._eval, 1), dev)

    def _body(self):
        loss = torch.sum(self.x)
        n = self.x.shape[0]
        k = int(n)
        {body}

    def _eval(self, i):
        {eval}

    def host(self):
        return float(torch.sum(self.x))


def plain(x):
    def body():
        return x.item()
    return body


def run(dev, x):
    def body():
        {closure}
    return Graphed(body, dev)
"""


def line_of(template: str, slot: str) -> int:
    return template.splitlines().index(
        next(x for x in template.splitlines() if slot in x)) + 1


@pytest.mark.parametrize("body, eval_, closure, fire", [
    ("self.out = loss", "self.out = self.x", "x.add_(1)", ()),
    ("self.out = loss.item()", "self.out = self.x", "x.add_(1)",
     ("{body}",)),
    ("self.out = float(loss)", "self.out = self.x", "x.add_(1)",
     ("{body}",)),
    ("self.out = self.x", "self.out = self.x.tolist()", "x.add_(1)",
     ("{eval}",)),
    ("self.out = loss", "torch.cuda.synchronize()", "x.add_(1)",
     ("{eval}",)),
    ("self.out = loss", "self.out = self.x", "x.cpu()", ("{closure}",)),
    ("self.out = int(torch.argmax(loss))", "self.out = self.x",
     "x.numpy()", ("{body}", "{closure}")),
    ("self.out = loss.item()  # netlint: disable=PRT002",
     "self.out = self.x", "x.add_(1)", ()),
], ids=["clean", "item", "float_of_tensor", "partial_method_tolist",
        "synchronize", "closure_cpu", "int_and_numpy", "suppressed"])
def test_prt002_host_syncs_in_graphed_bodies(tmp_path, body, eval_,
                                             closure, fire):
    """Only the bodies handed to Graphed (a method by ``self.name``, one
    through ``functools.partial``, a closure by name) are scanned: the
    host helpers ``host`` and ``plain`` sync freely, and ``int()`` of a
    shape is a host value."""
    got = lint_source(tmp_path, GRAPHED.format(body=body, eval=eval_,
                                               closure=closure))
    lines = [line_of(GRAPHED, slot) for slot in fire]
    assert got == ({"PRT002": lines} if lines else {})


def test_prt002_resolves_names_lexically(tmp_path):
    """A same-name host helper in a sibling scope is not the graphed
    body."""
    src = """
    from singa_tpu_torch.utils.graphs import Graphed

    class T:
        def a(self, dev):
            def fn():
                return None
            return Graphed(fn, dev)

        def b(self, v):
            def fn(v):
                return v.item()
            return fn(v)
    """
    assert lint_source(tmp_path, src) == {}
    graphed = src.replace("return None", "return self.x.item()")
    assert lint_source(tmp_path, graphed) == {"PRT002": [7]}


# ---------------------------------------------------------------------------
# PRT003: the card tests decide inside their fixture
# ---------------------------------------------------------------------------


CARD_TESTS = """
import pytest
import torch

{top}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


{deco}
def test_x(cuda_device, n=1):
    assert torch.cuda.device_count() >= n
"""


@pytest.mark.parametrize("top, deco, lines", [
    ("", "", []),
    ("HAS_CUDA = torch.cuda.is_available()", "", [5]),
    ("", "@pytest.mark.skipif(True, reason='x')", [15]),
    ("", "@pytest.mark.skipif(not torch.cuda.is_available(), reason='x')",
     [15, 15]),
    ("pytestmark = pytest.mark.skipif(True, reason='x')", "", [5]),
    ("HAS = torch.cuda.is_available()  # netlint: disable=PRT003", "", []),
], ids=["fixture_only", "import_time", "skipif", "skipif_on_cuda",
        "module_mark", "suppressed"])
def test_prt003_in_the_card_tests(tmp_path, top, deco, lines):
    src = CARD_TESTS.format(top=top, deco=deco)
    got = lint_source(tmp_path, src, name="test_torch_cuda.py")
    assert got == ({"PRT003": lines} if lines else {})
    # other test files may skip as they like
    assert lint_source(tmp_path, src, name="test_torch_other.py") == {}


# ---------------------------------------------------------------------------
# the shared machinery: parse failures, suppressions, the walk
# ---------------------------------------------------------------------------


def test_prt000_parse_failure_and_unreadable_file(tmp_path):
    assert lint_source(tmp_path, "def broken(:\n") == {"PRT000": [1]}
    p = tmp_path / "binary.py"
    p.write_bytes(b"\xff\xfe not utf8")
    col = Collector()
    lint_python_file(str(p), col)
    assert [d.code for d in col.sorted()] == ["PRT000"]


def test_suppression_forms(tmp_path):
    """Bare ``disable`` silences every code; trailing prose after the
    list does not corrupt it; another code's disable does not silence
    this one; a multi-line import carries it on any of its lines."""
    src = (
        "import jax  # netlint: disable\n"
        "import jax.numpy  # netlint: disable=PRT001 TODO revisit\n"
        "import singa_tpu  # netlint: disable=PRT002\n"
        "from jax import (\n"
        "    lax,\n"
        ")  # netlint: disable=PRT001\n"
    )
    got = lint_source(tmp_path, src, package="singa_tpu_torch")
    assert got == {"PRT001": [3]}


def test_self_lint_is_clean(capsys):
    """--self over singa_tpu_torch/ (and the overlapping path given
    again) reports nothing; so do chip_smoke.py and the card tests."""
    col = Collector()
    assert lint_python_tree(str(PKG), col) > 100
    assert col.sorted() == []
    rc = t_cli.main(["--self", str(PKG / "lint"), str(REPO / "chip_smoke.py"),
                     str(REPO / "tests" / "test_torch_cuda.py"),
                     "--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["diagnostics"] == []
    rc = t_cli.main(["--self", "--strict"])
    out = capsys.readouterr().out
    n = len(list(PKG.rglob("*.py")))
    assert rc == 0 and out.strip() == (
        f"netlint: {n} target(s), 0 error(s), 0 warning(s)")
