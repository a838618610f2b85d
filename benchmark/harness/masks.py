"""The program's dropout and SpecAugment masks, read back from the checked
steps, so the reference can apply the same ones.

The masks are draws of the program's own generator in its own order, which
an independent reference could reproduce only by copying the program.  So
while the checked steps run, every module of the program that holds
``fast_dropout`` or ``spec_augment`` gets a wrapper that first calls the
program's own function on ones, with a copy of the generator in the state
the real call will find, and then makes the real call: the copy's draws are
the real call's draws, so the ones come back as the mask the real call
applies.  The real call, its generator and everything after it are left as
they are.  Calls inside the backward pass (a checkpointed block's recompute,
which replays its forward's draws) are not recorded again.  The window runs
the program unwrapped.

What is kept, on the host, per step and in the order of the calls: each
dropout mask as a keep mask (bool, the shape of the dropped tensor) and
each SpecAugment mask as a keep mask over (rows, frames, mel bins).  No
scale is kept: the reference applies the configuration's rate itself.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, List

PACKAGE = "rnntransducer_tpu_torch"


def _copy(gen):
    import torch
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


class MaskLog:
    """The masks of one step: ``dropout`` and ``spec`` keep masks (bool CPU
    tensors) in call order."""

    def __init__(self):
        self.dropout: List = []
        self.spec: List = []

    def as_dict(self) -> Dict[str, list]:
        return {"dropout": list(self.dropout), "spec": list(self.spec)}


@contextlib.contextmanager
def read_back(log: MaskLog):
    """Within the block, every call of the program's ``fast_dropout`` and
    ``spec_augment`` that draws records its keep mask into ``log``."""
    import torch
    from rnntransducer_tpu_torch.frontend import specaugment
    from rnntransducer_tpu_torch.models import cells

    drop0, spec0 = cells.fast_dropout, specaugment.spec_augment

    def fast_dropout(x, rate, generator):
        # a checkpointed block's recompute in the backward replays its
        # forward's masks: those are recorded once, in the forward
        if generator is not None and torch._C._current_graph_task_id() == -1:
            ones = torch.ones_like(x)
            m = drop0(ones, rate, _copy(generator))
            if m is not ones:
                log.dropout.append((m != 0).to("cpu"))
        return drop0(x, rate, generator)

    def spec_augment(feats, generator, *args, **kwargs):
        keep = spec0(torch.ones_like(feats), _copy(generator), *args, **kwargs) != 0
        log.spec.append(keep.to("cpu"))
        return spec0(feats, generator, *args, **kwargs)

    swaps = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == PACKAGE or name.startswith(PACKAGE + ".")):
            continue
        for attr, orig, wrap in (("fast_dropout", drop0, fast_dropout),
                                 ("spec_augment", spec0, spec_augment)):
            if getattr(mod, attr, None) is orig:
                swaps.append((mod, attr, orig))
                setattr(mod, attr, wrap)
    try:
        yield log
    finally:
        for mod, attr, orig in swaps:
            setattr(mod, attr, orig)
