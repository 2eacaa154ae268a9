"""The vocoder's ResBlock1 convolutions as the MRF-stage and ResBlock
kernels compute them: per conv 2·taps·C_in·C_out·rows·frames operations
at the call's shape, counted once (no halo rows, no 3×TF32 products).
Bytes per kernel call: its input read and its output written once, its
weights and biases read once.

A generator forward over a mel of (rows, frames) runs, at stage i,
channels C_i = C_0 / 2^(i+1) over frames·∏rates[:i+1] samples: the stages
with C ≤ 128 in one MRF-stage call, the others in one ResBlock call per
kernel size."""

from roofline.peaks import BYTES, bound_s


def stage_shapes(structure, rows, frames):
    """[(channels, samples)] of each stage of one generator forward."""
    c, t, out = structure["upsample_initial_channel"], frames, []
    for u in structure["upsample_rates"]:
        c, t = c // 2, t * u
        out.append((c, t))
    return out


def block_ops(channels, samples, rows, kernel, dilations) -> float:
    return 2.0 * 2 * len(dilations) * kernel * channels * channels * rows * samples


def calls(structure, rows, frames, dtype="float32"):
    """[(kernel, operations, bytes)] of the kernel calls of one forward."""
    out, b = [], BYTES[dtype]
    ks, dils = structure["resblock_kernel_sizes"], structure["resblock_dilations"]
    for c, t in stage_shapes(structure, rows, frames):
        act = 2.0 * rows * t * c * b
        weights = [2 * len(d) * (k * c * c + c) * 4.0 for k, d in zip(ks, dils)]
        if c <= 128:
            out.append(("mrf", sum(block_ops(c, t, rows, k, d) for k, d in zip(ks, dils)),
                        act + sum(weights)))
        else:
            out += [("resblock", block_ops(c, t, rows, k, d), act + w)
                    for k, d, w in zip(ks, dils, weights)]
    return out


def bound(structure, rows, frames, dtype="float32") -> float:
    return sum(bound_s(ops, nbytes, dtype) for _, ops, nbytes in calls(structure, rows, frames, dtype))
