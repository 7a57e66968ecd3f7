"""The uniform draws of a training step.

JAX threefry keys and ``torch.Generator``s never give the same numbers, so
every random stage of the port takes its uniform [0, 1) float32 draws from a
``UniformDraws``: by name from ``given`` where present (a test hands the
numbers that ``jax.random.uniform`` drew from the JAX package's key splits;
one run hands another what it drew), else from ``generator``. Names used by
the training step: ``rpn.pos`` / ``rpn.neg`` (N, anchors), ``rcnn.pos`` /
``rcnn.neg`` (B, candidates), ``random_boxes`` (N, 4, boxes). OA-Mix draws
its table on the host, from ``host_generator(generator)``.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Sequence

import torch


class UniformDraws:
    """Named uniform [0, 1) float32 draws; ``drawn`` keeps every draw
    handed out, on the device it was made on."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 given: Optional[Dict[str, torch.Tensor]] = None):
        self.generator = generator
        self.given = dict(given or {})
        self.drawn: Dict[str, torch.Tensor] = {}

    def __call__(self, name: str, shape: Sequence[int], device) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if name in self.given:
            u = torch.as_tensor(self.given[name], dtype=torch.float32)
            if tuple(u.shape) != shape:
                raise ValueError(f"draws {name!r} have shape {tuple(u.shape)}, "
                                 f"the step needs {shape}")
        elif self.generator is not None:
            u = torch.rand(shape, generator=self.generator,
                           device=self.generator.device)
        else:
            raise KeyError(f"no draws {name!r} were given and no generator")
        self.drawn[name] = u
        return u.to(device)


def host_generator(generator: torch.Generator) -> torch.Generator:
    """The CPU generator of a step's host-side draws. A CPU ``generator`` is
    returned as it is. A CUDA generator keeps its seed and Philox offset on
    the host, so a CPU generator seeded from them costs no device sync; it
    changes from step to step as the step's device draws advance the
    offset."""
    if generator.device.type == "cpu":
        return generator
    state = bytes(generator.get_state().tolist())
    seed = int.from_bytes(hashlib.sha256(state).digest()[:8], "little") >> 1
    return torch.Generator().manual_seed(seed)
