"""Roofline: the card's peaks (`hw`), the analytic cost of a DeltaGrad
replay span (`replay`), which the tracer attaches to every
``replay.scan`` and ``online.request`` span, and the analytic FLOPs and
HBM bytes of a train, prefill or decode step of any model at any shape
(`model`)."""

from repro_torch.roofline.hw import H100_SXM5_80GB, HwSpec  # noqa: F401
from repro_torch.roofline.model import AnalyticCost, analytic_cost  # noqa: F401
