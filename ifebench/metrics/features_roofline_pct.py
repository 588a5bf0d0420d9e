"""features_roofline_pct (device trace): the least time the card could
take for the traced scans' feature passes, summed over scans and scales,
as a share of the device-busy time of the traced window, which holds
nothing but those passes. It reads no kernel name, so it stays valid when
kernels are fused or renamed.

The least time of one scale is the larger of two terms (floor_ms):
  * bytes / 3.35 TB/s: the image (4 B) and the mask (as given, 1 B) read
    once and the 8 f32 channels written once, per voxel of the volume;
  * operations / 67 TFLOP/s (the H100 SXM's float32 peak outside the
    tensor cores), counted only for voxels inside the mask, so the share
    stays a lower bound when a kernel skips what the mask leaves empty:
    the numerator and the denominator of the normalized convolution,
    each 2 FLOP a tap over the three axes' 2r + 1 taps, and TAIL_FLOP.

TAIL_FLOP counts the reference's formulas (ifebench/reference.py) a
voxel: the certainty product c*f 1 and the divide 1; the three first
differences 6 and the gradient magnitude 6 (3 mul, 2 add, sqrt); the
three second differences 12 (4 each); the three cascaded cross
differences 6; the eigenvalues 51 (p1 5, q 3, the deviations 3, p2 7, p
2, the determinant 14, r 4, phi 2, the two cosine roots 4 + 4, the third
by the trace 3; an acos, cos or sqrt counts 1, a comparison 0); the sum,
product and Frobenius norm 10.
"""
import math

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
TAIL_FLOP = 93
OUT_BYTES = 8 * 4
IMAGE_BYTES = 4


def radius(sigma, spacing, truncate):
    return max(1, int(math.ceil(truncate * float(sigma) / float(spacing))))


def bytes_ms(shape, mask_bytes=1):
    voxels = math.prod(int(n) for n in shape)
    return voxels * (IMAGE_BYTES + mask_bytes + OUT_BYTES) / PEAK_BYTES_S * 1e3


def flop_ms(sigma, spacing, truncate, mask_count):
    taps = sum(2 * radius(sigma, h, truncate) + 1 for h in spacing)
    return mask_count * (2 * 2 * taps + TAIL_FLOP) / PEAK_FLOP_S * 1e3


def floor_ms(shape, spacing, sigma, truncate, mask_count, mask_bytes=1):
    return max(bytes_ms(shape, mask_bytes),
               flop_ms(sigma, spacing, truncate, mask_count))


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.busy_s <= 0:
        return None
    run = ctx.run
    least = sum(floor_ms(run.shape, run.spacing, s, run.truncate,
                         run.mask_counts[slot], run.mask_bytes)
                for slot in ctx.traced_slots for s in run.sigmas)
    return 100.0 * least * 1e-3 / t.busy_s
