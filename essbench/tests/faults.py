"""Faults planted under a run's timed path, for the tests that show the
check catches them (``monkeypatch`` applies and removes each).

* ``token``: a served token altered where it is produced (the session's
  emission, or the fixed batch's argmax);
* ``state``: a decode step that leaves its state unchanged: the latent rows
  of new tokens are never written (the ESS host tier, or the monolithic
  cache);
* ``half``: half of the batch left out: the second half of the rows takes
  the first half's logits.

A one-chip cell exchanges nothing between chips, so that fault has no
place here.
"""

from __future__ import annotations

FAULTS = ("token", "state", "half")


def _half(logits):
    B = logits.shape[0]
    h = B // 2
    out = logits.clone()
    out[B - h:] = logits[:h]
    return out


def plant(monkeypatch, fault: str, traffic: str) -> None:
    from repro_torch.core import offload
    from repro_torch.models import blocks
    from repro_torch.serving import engine as E

    if fault == "token":
        if traffic == "fixed_batch_replay":
            real = E.generic_decode

            def decode(*a, **k):
                out = real(*a, **k)
                return out._replace(logits=out.logits.roll(1, dims=-1))
            monkeypatch.setattr(E, "generic_decode", decode)
        else:
            real_emit = E.ServeSession._emit

            def emit(self, slot, req, tokens, now=None):
                V = self.cfg.vocab_size
                return real_emit(self, slot, req,
                                 [(t + V // 2) % V for t in tokens], now)
            monkeypatch.setattr(E.ServeSession, "_emit", emit)
    elif fault == "state":
        if traffic == "fixed_batch_replay":
            monkeypatch.setattr(blocks, "_append_at", lambda *a, **k: None)
        else:
            monkeypatch.setattr(offload, "scatter_tier_rows",
                                lambda *a, **k: None)
    elif fault == "half":
        name = "generic_decode" if traffic == "fixed_batch_replay" \
            else "ess_decode"
        real = getattr(E, name)

        def step(*a, **k):
            out = real(*a, **k)
            return out._replace(logits=_half(out.logits))
        monkeypatch.setattr(E, name, step)
    else:
        raise ValueError(fault)
