"""Weights from a seed, made on the device in one draw, in the precision
the model is served in.

Every parameter of a configuration's spec (its reference's
``parameter_spec``) is a slice of one float32 normal draw from a
``torch.Generator`` on the device, scaled by its kind:

* matrices ``N(0, 1/fan_in)`` and embeddings ``N(0, 1/hidden)``: the scale
  of a trained BERT's weights (about 0.04 at width 768), under which every
  sublayer moves the output, rather than the 0.02 of its initialisation,
  under which the encoder is close to the identity and a precision change
  hardly shows;
* biases and LayerNorm shifts ``N(0, 0.02^2)``, LayerNorm scales
  ``1 + N(0, 0.02^2)``, so that none of them is left at a value that would
  hide a fault in reading it.

The draw is then rounded, in one cast, to the precision the configuration
serves the model in (bfloat16 for a bf16 configuration): those rounded
values are the configuration's model.  The program is handed them (it may
hold them in a wider type, which keeps them exact) and the reference reads
them in float32, so rounding the weights is no gap between the two; the
gap left is what the program's computation loses.  The same seed on the
same kind of device gives the same numbers.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from .traffic import seed_of

SMALL = 0.02


def make_weights(spec: Iterable[Tuple[str, Tuple[int, ...], str, int]], seed: int,
                 device, dtype: str = "float32") -> Dict[str, torch.Tensor]:
    spec = list(spec)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 5) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    offset = 0
    for (name, shape, kind, fan_in), size in zip(spec, sizes):
        t = flat[offset : offset + size]
        offset += size
        if kind in ("matrix", "embedding"):
            t.mul_(fan_in ** -0.5)
        elif kind == "ln_weight":
            t.mul_(SMALL).add_(1.0)
        else:
            t.mul_(SMALL)
    flat = flat.to(getattr(torch, dtype))
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for (name, shape, _, _), size in zip(spec, sizes):
        out[name] = flat[offset : offset + size].view(shape)
        offset += size
    return out
