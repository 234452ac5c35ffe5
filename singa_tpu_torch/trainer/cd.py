"""Contrastive-divergence trainer, from ``singa_tpu/trainer/cd.py``.

The net is a chain data -> parsers -> kRBM+ (stacked RBMs). One step
runs greedy layerwise CD: each RBM gets a CD-k update on the mean-field
hidden activations of the (simultaneously training) RBM below it. The
grads come from the Gibbs chain (``RBMLayer.cd_grads``), not from
autograd, and go through the regular reduction and updater, so
momentum, weight decay and the LR schedules apply to them as to
backprop grads. Stacked pretraining feeds a deep autoencoder:
:func:`unroll_autoencoder` turns the stack's checkpoint into the init
of ``examples/mnist/autoencoder.conf``.

The chain draws activation-sized uniforms on the device, so the step
is eager (the Trainer's dispatch rule). Under a divergence guard the
verdict is the finiteness of the CD grads' global norm and of every
RBM's metrics (there is no backprop loss to watch; a NaN batch shows in
both), taken in the Trainer's eager tail, which also folds the LR
backoff into the CD grads and drops a bad step's update.
"""

from __future__ import annotations

import torch

from ..config.schema import ConfigError
from ..layers.rbm import RBMLayer
from ..utils.rng import fold_in
from .checkpoint import load_checkpoint, save_checkpoint
from .trainer import _GUARD_METRIC, Trainer


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
        """One CD step per rank: walk the net through Net.forward (its
        shared-param and connector routing kept), swapping each RBM's
        compute for a Gibbs-chain update; then the RBM params' CD grads
        through the reduction and the updater. Grads never flow between
        RBMs: greedy layerwise training by construction."""
        n = self.mesh.width
        step_gen = fold_in(self._step_gen, step)
        grads, metrics = [], []
        for r in self.mesh.local_ranks:
            dev = self.mesh.device(r)
            g, m = {}, {}

            def hook(layer, resolved, inputs, lgen):
                if isinstance(layer, RBMLayer):
                    lg, lm = layer.cd_grads(resolved, inputs[0], lgen)
                    g.update(lg)
                    m[layer.name] = lm
                    return layer.prop_up(resolved, inputs[0])
                return None

            self.train_net.forward(
                self._replicas[dev]["params"], self._rank_batch(batch, r),
                training=True, generator=fold_in(step_gen, r),
                layer_hook=hook,
            )
            # CD grads are batch means: / n makes their sum the global one
            grads.append({nm: v / n for nm, v in g.items()})
            if self._guard is not None:
                # the tail's verdict reads a "loss": NaN unless every RBM
                # metric is finite (the grads' norm it checks itself)
                fin = torch.stack([torch.isfinite(torch.as_tensor(v)).all()
                                   for ms in m.values()
                                   for v in ms.values()]).all()
                m[_GUARD_METRIC] = {"loss": torch.where(
                    fin, torch.zeros((), device=dev),
                    torch.full((), float("nan"), device=dev))}
            metrics.append(m)
        return self._reduce_and_update(step, grads, metrics)

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
