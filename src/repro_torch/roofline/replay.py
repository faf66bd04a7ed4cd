"""Analytic roofline for DeltaGrad replay spans.

Prices the REPLAY step the unlearning engine runs — the L-BFGS-corrected
update of Algorithm 1/3 — so the span tracer (`repro_torch.obs.trace`)
can attach a predicted cost to every approx segment and the exported
trace carries measured-vs-roofline ratios.  The formulas are the JAX
package's `roofline.replay`, term for term.

Per approximate (corrected) step over P parameters with a changed-row
block of width r (the schedule's pow2 pad) and an m-pair history ring:

    FLOPs:  changed-row gradient (fwd+bwd over r examples, first-order
            matmul-exact for the linear family: ~6·r·P), the masked
            compact two-loop correction (~8·m·P), and the fused update
            arithmetic (~10·P);
    bytes:  the streamed history entry (w_t, g_t) in and the rewritten
            (w, g) out (4·P·dtype), the stacked pair ring (4·m·P·dtype),
            the changed-row features (r·P·dtype), and the parameter
            carry (2·P·dtype).

The replay computes in f32 on the CUDA cores (no tensor cores: TF32 is
off), so its FLOPs are priced at the card's f32 peak, ``hw.peak_flops_f32``
— the reference prices them at its chip's bf16 peak.  The prediction is
``max(flops / peak, bytes / bw)`` on the given `HwSpec` — a LOWER BOUND on
wall time, so the measured/predicted ratio reads as distance from the
roofline: ~1 means the segment is hardware-bound, ≫1 means launch or host
overheads dominate.  The measured side is a host-timed span: on the card
it stops when the segment's launches are queued, not when they finish.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.roofline.hw import H100_SXM5_80GB, HwSpec

__all__ = ["ReplayCost", "replay_step_cost", "scan_segment_cost"]


@dataclass(frozen=True)
class ReplayCost:
    """Roofline prediction for a replay span."""

    flops: float
    hbm_bytes: float
    t_compute: float
    t_memory: float

    @property
    def pred_s(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def bound(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"


def replay_step_cost(n_params: int, r_changed: int, m_history: int,
                     momentum: bool = False, dtype_bytes: int = 4,
                     hw: HwSpec = H100_SXM5_80GB) -> ReplayCost:
    """Cost of ONE corrected replay step (see the module docstring)."""
    P = float(max(1, n_params))
    r = float(max(1, r_changed))
    m = float(max(0, m_history))
    flops = 6.0 * r * P + 8.0 * m * P + 10.0 * P
    if momentum:
        flops += 4.0 * P
    hbm = dtype_bytes * (4.0 * P        # (w_t, g_t) in, rewritten out
                         + 4.0 * m * P  # stacked dW/dG pair ring
                         + r * P        # changed-row feature block
                         + 2.0 * P)     # parameter carry in/out
    return ReplayCost(flops=flops, hbm_bytes=hbm,
                      t_compute=flops / hw.peak_flops_f32,
                      t_memory=hbm / hw.hbm_bw)


def scan_segment_cost(n_params: int, steps: int, r_changed: int,
                      m_history: int, momentum: bool = False,
                      dtype_bytes: int = 4,
                      hw: HwSpec = H100_SXM5_80GB) -> ReplayCost:
    """Cost of an approx segment of ``steps`` corrected replay steps."""
    one = replay_step_cost(n_params, r_changed, m_history,
                           momentum=momentum, dtype_bytes=dtype_bytes,
                           hw=hw)
    s = float(max(1, steps))
    return ReplayCost(flops=one.flops * s, hbm_bytes=one.hbm_bytes * s,
                      t_compute=one.t_compute * s,
                      t_memory=one.t_memory * s)
