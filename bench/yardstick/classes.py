"""Ten-class planted rows made from the run's seed, on the device.

The port's own stand-in for a C-class dataset (`data/pipeline.
multiclass_dataset`), made here with a `torch.Generator` so that the same
seed gives the same arrays without the program's help: C unit class
directions mu_c ~ N(0, I) / |.|, labels uniform over the C classes, and
rows x = clip(mu_y * margin * 0.5 + N(0, 0.5^2), -1, 1).  The stream is
the run's "rows" stream (`data.generator`), as for the binary rows.
"""

from __future__ import annotations

import torch

from yardstick import data


def class_rows(m: int, d: int, n_classes: int, margin: float, seed: int,
               device, purpose: str = "rows"):
    """(x float32 (m, d), y int32 (m,) in [0, n_classes)) as host arrays."""
    gen = data.generator(seed, purpose, device)
    mu = torch.randn((n_classes, d), generator=gen, device=device,
                     dtype=torch.float64)
    mu /= mu.norm(dim=1, keepdim=True)
    y = torch.randint(0, n_classes, (m,), generator=gen, device=device)
    x = torch.randn((m, d), generator=gen, device=device) * 0.5
    x += (mu * (margin * 0.5)).to(torch.float32)[y]
    x.clamp_(-1.0, 1.0)
    return x.cpu().numpy(), y.to(torch.int32).cpu().numpy()
