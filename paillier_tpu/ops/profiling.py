"""Profiling and roofline accounting for the hot ladders.

The reference has no performance tooling at all (SURVEY section 5: only
``testing.B`` harnesses).  This module provides:

* :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-loadable trace of whatever runs inside it.
* :data:`PEAKS` / :func:`device_peaks` — published peak rates keyed by
  ``device_kind``.  A device without a row is an error, never a default.
* :class:`RooflineModel` — analytic speed-of-light accounting for the
  RNS-v2 modular-exponentiation ladders (bigint/rns2.py), so a measured
  throughput can be quoted as a share of each bound.

Per Montgomery multiply and element, with k channels per base (see
rns2.rns2_mont_mul_pair):

  int8  2 merged dots [B,2k]x[2k,2*pk] = 8k^2 MACs ideal; the lo/hi chunk
        column groups sit at offsets 0 and pk = ceil(k/128)*128, so the
        issued cost is 2k * 2*pk per extension.
  bytes the ladder carry, [C=2k] int32, read and written once: 16k bytes.
        An XLA program that keeps the carry in device memory between
        multiplies moves at least this much.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass


@dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one device."""

    name: str
    int8_tops: float          # dense int8 tensor-core tera-ops/s (MAC = 2)
    hbm_gbps: float           # device-memory bandwidth, GB/s
    source: str


PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        "H100 SXM", int8_tops=1979.0, hbm_gbps=3350.0,
        source="NVIDIA H100 SXM data sheet: dense int8 (no sparsity), "
               "HBM3 bandwidth, at the 700 W power limit"),
}


def device_peaks(kind: str | None = None) -> DevicePeaks:
    """Peaks for ``kind`` (default: ``jax.devices()[0].device_kind``)."""
    if kind is None:
        import jax
        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add a row to "
            "paillier_tpu.ops.profiling.PEAKS") from None


def sliding_mults(e_bits: int, window: int) -> int:
    """Montgomery multiplies of the shared-exponent sliding-window ladder
    (rns2.sliding_window_schedule): squarings + expected window hits +
    odd-power table build + entry/exit."""
    return e_bits + e_bits // (window + 1) + (1 << (window - 1)) + 2


def fixed_window_mults(e_bits: int, window: int) -> int:
    d = -(-e_bits // window)
    return d * (window + 1) + (1 << window) + 1


@dataclass
class RooflineModel:
    """Speed-of-light accounting for one batched modexp configuration."""

    mod_bits: int             # modulus width (e.g. 4096 for mod n^2)
    exp_bits: int             # exponent width (e.g. 2048 for r^n)
    k: int                    # RNS channels per base (Rns2Spec.k)
    window: int = 6
    sliding: bool = True
    peaks: DevicePeaks = None

    def __post_init__(self):
        if self.peaks is None:
            self.peaks = device_peaks()

    @property
    def mults(self) -> int:
        if self.sliding:
            return sliding_mults(self.exp_bits, self.window)
        return fixed_window_mults(self.exp_bits, self.window)

    @property
    def macs_per_mult(self) -> int:
        """Ideal int8 MACs per Montgomery multiply (2 base extensions)."""
        return 8 * self.k * self.k

    @property
    def macs_per_mult_padded(self) -> int:
        """With the k-wide dot outputs padded to 128-column groups."""
        kp = -(-self.k // 128) * 128
        return 2 * (2 * self.k) * 2 * kp

    @property
    def bytes_per_mult(self) -> int:
        """Carry traffic per element: [2k] int32 read + written."""
        return 2 * (2 * self.k) * 4

    def int8_bound(self, padded: bool = True) -> float:
        """Elements/sec at 100% of the int8 tensor-core peak."""
        macs = (self.macs_per_mult_padded if padded else self.macs_per_mult)
        return self.peaks.int8_tops * 1e12 / (2.0 * macs * self.mults)

    def memory_bound(self) -> float:
        """Elements/sec at 100% of device-memory bandwidth."""
        return (self.peaks.hbm_gbps * 1e9
                / (self.bytes_per_mult * self.mults))

    def bound(self) -> float:
        """The roofline: the lower of the two bounds."""
        return min(self.int8_bound(), self.memory_bound())

    def report(self, measured: float | None = None) -> str:
        which = ("int8" if self.int8_bound() <= self.memory_bound()
                 else "memory")
        lines = [
            f"roofline {self.peaks.name}: mod={self.mod_bits}b "
            f"exp={self.exp_bits}b k={self.k} "
            f"{'sliding' if self.sliding else 'fixed'}-w{self.window} "
            f"({self.mults} mmuls, {self.macs_per_mult_padded} padded "
            f"MACs/mmul, {self.bytes_per_mult} B/mmul)",
            f"  int8 speed-of-light   : {self.int8_bound():>12,.0f} elem/s "
            f"(unpadded: {self.int8_bound(False):,.0f})",
            f"  memory speed-of-light : {self.memory_bound():>12,.0f} elem/s",
            f"  roofline ({which}-bound): {self.bound():>11,.0f} elem/s",
        ]
        if measured:
            lines.append(
                f"  measured              : {measured:>12,.0f} elem/s = "
                f"{measured / self.bound():.1%} of the roofline")
        return "\n".join(lines)


def encryption_roofline(pk_bits: int = 2048, window: int = 6,
                        peaks: DevicePeaks | None = None) -> RooflineModel:
    """Roofline for regular encryption's r^(n^s) ladder at level 1:
    exponent n (pk_bits), modulus n^2 (2*pk_bits)."""
    from ..bigint.rns2 import Rns2Spec
    # channel count for the n^2-width engine without a real key: k depends
    # only on the modulus bit length; synthesize one of the right size
    probe = (1 << (2 * pk_bits - 1)) | 1
    k = Rns2Spec(probe).k
    return RooflineModel(mod_bits=2 * pk_bits, exp_bits=pk_bits, k=k,
                         window=window, sliding=True, peaks=peaks)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace of the enclosed block (TensorBoard format)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
