"""Roofline: the card's peaks (`hw`) and the analytic cost of a DeltaGrad
replay span (`replay`), which the tracer attaches to every
``replay.scan`` and ``online.request`` span."""

from repro_torch.roofline.hw import H100_SXM5_80GB, HwSpec  # noqa: F401
