"""TrainState: what one training step transforms."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

from repro_torch.utils.tree import FlatParams


class TrainState(NamedTuple):
    params: FlatParams
    opt_state: Dict[str, Any]
    step: int


def init_state(params: FlatParams, optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params.flat),
                      step=0)
