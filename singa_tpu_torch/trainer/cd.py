"""Contrastive-divergence trainer, from ``singa_tpu/trainer/cd.py``.

The net is a chain data -> parsers -> kRBM+ (stacked RBMs). One step
runs greedy layerwise CD: each RBM gets a CD-k update on the mean-field
hidden activations of the (simultaneously training) RBM below it. The
grads come from the Gibbs chain (``RBMLayer.cd_grads``), not from
autograd, and go through the grad_comm seam and the updater, so
momentum, weight decay and the LR schedules apply to them as to
backprop grads. Stacked pretraining feeds a deep autoencoder:
:func:`unroll_autoencoder` turns the stack's checkpoint into the init
of ``examples/mnist/autoencoder.conf``.

On every mesh the step is the JAX program's one chain over the global
batch, so the draws are those of the global shapes on any number of
data ranks; on a data x model mesh (kLayerPartition splits each RBM's
hidden units) each model rank's hidden units come from its shards.

The chain draws activation-sized uniforms on the device, so the step
is eager (the Trainer's dispatch rule). Under a divergence guard the
verdict is the finiteness of the CD grads' global norm and of every
RBM's metrics (there is no backprop loss to watch; a NaN batch shows in
both), taken at the step's end (``guard_grads``), which also folds the
LR backoff into the CD grads and drops a bad step's update.
"""

from __future__ import annotations

import torch

from ..config.schema import ConfigError
from ..layers.rbm import RBMLayer
from ..utils.rng import fold_in
from .checkpoint import load_checkpoint, save_checkpoint
from ..resilience.guard import guard_finish, guard_grads
from .trainer import Trainer


def unroll_autoencoder(
    ckpt_in: str, ckpt_out: str, pairs: list[tuple[str, str]]
) -> str:
    """Unroll a pretrained RBM stack into autoencoder decoder weights.

    For each (rbm_layer, decoder_layer) pair, the decoder InnerProduct
    layer gets weight = rbm_weight^T and bias = rbm_vbias (the classic
    Hinton unrolling), and the encoder InnerProduct named after the RBM
    gets bias = rbm_hbias (its weight is the RBM's, by name). The result
    is a step-0 checkpoint for ModelConfig.checkpoint / kPretrained
    init, with the JAX package's keys."""
    _, params, _, _ = load_checkpoint(ckpt_in)
    out = dict(params)
    for rbm, dec in pairs:
        w = params.get(f"{rbm}/weight")
        vb = params.get(f"{rbm}/vbias")
        hb = params.get(f"{rbm}/hbias")
        if w is None or vb is None or hb is None:
            raise ConfigError(
                f"checkpoint {ckpt_in!r} has no RBM params for {rbm!r}"
            )
        out[f"{dec}/weight"] = w.T
        out[f"{dec}/bias"] = vb
        out[f"{rbm}/bias"] = hb
    # step 0: fine-tuning starts a fresh step counter, not the CD one
    return save_checkpoint(ckpt_out, 0, out)


class CDTrainer(Trainer):
    """Trainer whose step does CD-k instead of backprop."""

    #: the CD step rewires the forward through a layer hook
    _supports_buffers = False
    #: the CD walk is not the ring's per-rank backward
    _supports_ring_collective = False
    #: beside the data axis: the model axis (kLayerPartition's hidden
    #: units)
    _axis_sets = ({"model"},)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._rbms = [
            l for l in self.train_net.layers if isinstance(l, RBMLayer)
        ]
        if not self._rbms:
            raise ConfigError(
                "alg kContrastiveDivergence requires at least one kRBM layer"
            )
        if self.train_net.losslayers:
            raise ConfigError(
                "kContrastiveDivergence is unsupervised: remove loss layers "
                "(fine-tune the unrolled net with alg kBackPropagation)"
            )

    @torch.no_grad()
    def _step_core(self, step: int, batch: dict) -> dict:
        """One CD step, the JAX program's: one chain over the global batch
        (its draws of the global shapes, on this process's first device;
        every process runs the same chain), walked through Net.forward
        (its shared-param and connector routing kept) with each RBM's
        compute swapped for a Gibbs-chain update, each model rank's
        hidden units from its shards under kLayerPartition
        (``RBMLayer.cd_grads_ranks``); the CD grads through the
        ``grad_comm`` seam, then each piece's to the update of the ranks
        that hold it (``_axes_update``). Grads
        never flow between RBMs: greedy layerwise training by
        construction."""
        stored = self._replicas[self.device]["params"]
        nmodel = self.mesh.widths.get("model", 1)
        grads, metrics = {}, {}

        def hook(layer, resolved, inputs, lgen):
            if not isinstance(layer, RBMLayer):
                return None
            names = list(layer.param_specs())
            ps = [self.train_net.resolve_params({
                nm: self._piece(nm, stored[nm], k) for nm in names})
                for k in range(nmodel if layer.model_split() else 1)]
            g, metrics[layer.name] = layer.cd_grads_ranks(ps, inputs[0],
                                                          lgen)
            grads.update(g)
            return layer._up_ranks(ps, layer._flat(ps[0], inputs[0]))

        self.train_net.forward(
            stored, {name: {k: v.to(self.device) for k, v in feed.items()}
                     for name, feed in batch.items()},
            training=True, generator=fold_in(fold_in(self._step_gen, step),
                                             0), layer_hook=hook)
        res = {}
        if self._comm is not None:
            grads, res = self._axes_seam(grads)
        ok = None
        if self._guard is not None:
            # the verdict reads a "loss": NaN unless every RBM metric is
            # finite (the grads' norm guard_grads checks itself)
            fin = torch.stack([torch.isfinite(torch.as_tensor(v)).all()
                               for ms in metrics.values()
                               for v in ms.values()]).all()
            ok, grads = guard_grads(
                self._guard_buffers(), torch.where(
                    fin, torch.zeros((), device=self.device),
                    torch.full((), float("nan"), device=self.device)),
                grads)
        self._store_buffers(res, ok)
        self._axes_update(step, grads, ok)
        if ok is not None:
            metrics = guard_finish(ok, self._guard_buffers(), metrics)
        return metrics

    @torch.no_grad()
    def _eval_batch_metrics(self, net, batch: dict) -> dict:
        """Eval metric per RBM: the mean-field reconstruction error."""
        metrics: dict = {}

        def hook(layer, resolved, inputs, lgen):
            if isinstance(layer, RBMLayer):
                metrics[layer.name] = {
                    "loss": layer.recon_error(resolved, inputs[0])
                }
                return layer.prop_up(resolved, inputs[0])
            return None

        net.forward(self.params, batch, training=False, layer_hook=hook)
        return metrics
