"""Parameters and images drawn from the seed, on the device, in a few
large calls."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

ALIGN = 64            # elements: every leaf starts on a 256-byte boundary


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 64-bit seeds derived from the run's seed."""
    ss = np.random.SeedSequence(int(seed) & (2 ** 64 - 1))
    return [int(s.generate_state(1, np.uint64)[0]) for s in ss.spawn(n)]


def _layout(specs) -> Tuple[Dict[str, int], list]:
    """Each leaf's offset in the normal or the uniform buffer."""
    size = {"normal": 0, "uniform": 0}
    placed = []
    for name, key, shape, init in specs:
        kind = init[0]
        placed.append((name, key, shape, init, size[kind]))
        size[kind] += -(-math.prod(shape) // ALIGN) * ALIGN
    return size, placed


def make_params(specs, seed: int, device: torch.device) -> dict:
    """``{name: {key: tensor}}`` from ``specs`` ((name, key, shape,
    ("normal", std) | ("normal", std, mean) | ("uniform", lo, hi))): one
    ``randn`` and one ``rand`` call on ``device``, each leaf a scaled fp32
    view of its slice."""
    size, placed = _layout(specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bufs = {kind: torch.empty(n, dtype=torch.float32, device=device)
            for kind, n in size.items()}
    bufs["normal"].normal_(generator=gen)
    bufs["uniform"].uniform_(generator=gen)
    params: dict = {}
    for name, key, shape, init, off in placed:
        t = bufs[init[0]][off:off + math.prod(shape)].view(shape)
        if init[0] == "normal":
            t.mul_(init[1])
            if len(init) > 2:
                t.add_(init[2])
        else:
            t.mul_(init[2] - init[1]).add_(init[1])
        params.setdefault(name, {})[key] = t
    return params


def make_images(n: int, img: int, seed: int,
                device: torch.device) -> np.ndarray:
    """The image pool: ``n`` standard-normal (3, img, img) fp32 images,
    drawn on ``device`` and kept on the host, where requests carry them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((n, 3, img, img), generator=gen, device=device)
    return x.cpu().numpy()
