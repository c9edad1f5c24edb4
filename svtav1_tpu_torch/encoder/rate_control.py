"""Rate control: CQP / CRF / VBR / CBR.

Copy of ``svtav1_tpu/encoder/rate_control.py`` (host code).

Maps the reference's rate-control process (EbRateControlProcess.c:
CQP :923, CRF crf_qindex_calc :782, CBR leaky-bucket loop :2089, VBR
:2484) onto a compact feedback controller around the hierarchical
encoder:

- CQP/CRF hold the base qindex; CRF adds the key-frame boost and the
  per-layer scaling the scheduler already applies (the content-adaptive
  part of crf_qindex_calc collapses into those two knobs at our preset
  point);
- CBR tracks a leaky bucket at the target bitrate: the base qindex
  follows the measured bits-per-frame ratio (EMA) plus a buffer-
  fullness correction, clamped to a per-update step like the
  reference's q-adjustment windows;
- VBR is the same controller with a slower gain and a wider buffer
  (average-bitrate semantics rather than a hard bucket).

The controller owns the BASE qindex; the GoP scheduler derives KF and
per-layer q from it exactly as in fixed-q operation, so RC composes
with the pyramid, TF, and all in-loop filters.
"""

from __future__ import annotations


class RateControl:
    MODES = ("cq", "crf", "cbr", "vbr")

    def __init__(self, mode: str = "cq", qindex: int = 100,
                 target_kbps: int = 0, fps: float = 30.0,
                 min_q: int = 8, max_q: int = 250):
        if mode not in self.MODES:
            raise ValueError(f"rc mode {mode!r} not in {self.MODES}")
        if mode in ("cbr", "vbr") and target_kbps <= 0:
            raise ValueError(f"{mode} needs a positive --tbr")
        self.mode = mode
        self.min_q = min_q
        self.max_q = max_q
        self._q = float(min(max(qindex, min_q), max_q))
        self.fps = fps
        self.target_bpf = target_kbps * 1000.0 / max(fps, 1e-6)  # bits
        # leaky bucket: one second of buffering (reference default
        # buf_sz semantics), start half full
        self.buffer_size = target_kbps * 1000.0
        self.fullness = self.buffer_size / 2.0
        self._ema_ratio = 1.0
        # CBR reacts per frame; VBR averages across ~a GoP
        self._gain = 0.35 if mode == "cbr" else 0.10
        self._frames = 0
        self.total_bits = 0

    # ---------------- q supply ---------------- #

    @property
    def base_q(self) -> int:
        return int(round(self._q))

    # ---------------- feedback ---------------- #

    def update(self, nbytes: int, shown_frames: int = 1) -> None:
        """Account one coded TU (nbytes) covering shown_frames display
        frames (show_existing overlays are ~free; pass 0 for no-show)."""
        bits = nbytes * 8.0
        self.total_bits += bits
        self._frames += max(shown_frames, 0)
        if self.mode in ("cq", "crf") or shown_frames <= 0:
            return
        target = self.target_bpf * shown_frames
        if target <= 0:
            return
        ratio = bits / target
        a = 0.25
        self._ema_ratio = (1 - a) * self._ema_ratio + a * ratio
        # bucket drains at the target rate
        self.fullness += bits - target
        self.fullness = max(-self.buffer_size,
                            min(self.buffer_size, self.fullness))
        # proportional step on log-q: overshoot -> raise q
        step = self._gain * (self._ema_ratio - 1.0)
        if self.mode == "cbr":
            step += 0.20 * (self.fullness / max(self.buffer_size, 1.0))
        step = max(-0.12, min(0.12, step))
        self._q *= (1.0 + step)
        self._q = max(self.min_q, min(self.max_q, self._q))

    # ---------------- reporting ---------------- #

    def achieved_kbps(self) -> float:
        if self._frames == 0:
            return 0.0
        return self.total_bits * self.fps / self._frames / 1000.0
