"""Speculative multi-token decode: model-free drafting for the engine.

A copy of ``singa_tpu/serve/speculate.py`` (pure Python), kept here so
the port imports nothing of the JAX package.

The serving engine's one-token tick is weight-streaming-bound: every
tick streams the full weights to emit one token per live slot
(tools/serve_bench.py measured it; the lm_d128_serve bench row notes
it). Speculative decoding amortizes that stream: draft ``k`` candidate
tokens per slot cheaply, score all ``(slots, k+1)`` positions in ONE
batched verify forward (serve/engine.py ``Engine.verify``), and emit
every accepted token — up to k+1 tokens for the cost of one weight
stream.

The drafters here are MODEL-FREE (no draft network, no extra weights to
stream — a draft model would re-pay the bandwidth the speculation is
trying to save at serving-tier batch sizes):

  ``NGramDrafter``   prompt-lookup / longest-suffix-match drafting
                     (arXiv 2304.04487, 2311.08252's observation that
                     LLM output heavily repeats its own context): find
                     the longest n-gram suffix of the sequence's own
                     prompt+emitted tokens that occurred earlier, and
                     propose the tokens that followed that occurrence.
                     Deterministic, O(context) per call, strong on the
                     repetitive/greedy workloads serving actually sees
                     (code, extraction, templated text — and the cyclic
                     continuations tiny greedy LMs emit in CI).
  ``NullDrafter``    never proposes: the machinery probe. A speculative
                     tick with zero drafts isolates the speculation
                     plumbing (verify program, acceptance lanes, KV
                     rewind) from the amortization win — serve_bench's
                     or-gate arm and the zero-acceptance parity tests
                     ride it.

Correctness is the verify step's job, not the drafter's: a drafter may
propose ANY tokens (garbage drafts cost acceptance rate, never
correctness). Greedy acceptance takes the longest prefix of the draft
matching the model's own argmax continuations plus one bonus token, so
the emitted stream is IDENTICAL to non-speculative greedy decode by
construction — speculation changes *when* tokens appear, never
*which*.
"""

from __future__ import annotations


class NGramDrafter:
    """Longest-suffix prompt-lookup drafting over the sequence's own
    context (prompt + emitted tokens).

    For n from ``ngram_max`` down to ``ngram_min``: take the context's
    trailing n-gram, scan for its most recent earlier occurrence, and
    propose (up to ``k``) tokens that followed it. The first n with a
    match wins — longer matches are better evidence the continuation
    repeats. Most-recent occurrence wins among matches (locality: the
    continuation nearest the cursor is likeliest to repeat next).
    Deterministic by construction, so speculative runs are replayable.
    """

    name = "ngram"

    def __init__(self, ngram_max: int = 4, ngram_min: int = 1):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{ngram_min}, {ngram_max}]"
            )
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def draft(self, ctx, k: int) -> list[int]:
        """``ctx`` (sequence of ints, prompt + emitted so far) -> up to
        ``k`` proposed continuation tokens ([] = nothing to propose)."""
        if k <= 0 or len(ctx) < 2:
            return []
        ctx = list(ctx)
        n_hi = min(self.ngram_max, len(ctx) - 1)
        for n in range(n_hi, self.ngram_min - 1, -1):
            tail = ctx[-n:]
            # most recent earlier occurrence: i is the match START, and
            # i + n <= len(ctx) - 1 keeps at least one follower token
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i:i + n] == tail:
                    return ctx[i + n:i + n + k]
        return []


class NullDrafter:
    """Proposes nothing, ever: every speculative tick degrades to the
    one-token tick (acceptance forced to zero by having nothing to
    accept). The machinery probe — serve_bench times this against the
    plain decode tick to isolate the speculation plumbing's cost — and
    the parity oracle for zero-acceptance tests."""

    name = "null"

    def draft(self, ctx, k: int) -> list[int]:
        return []


DRAFTERS = {"ngram": NGramDrafter, "null": NullDrafter}


def make_drafter(name: str):
    """Drafter registry lookup (the ``serving { speculate { drafter } }``
    vocabulary; config/schema.py SPEC_DRAFTERS mirrors DRAFTERS)."""
    try:
        return DRAFTERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown drafter {name!r}; have {sorted(DRAFTERS)}"
        ) from None
