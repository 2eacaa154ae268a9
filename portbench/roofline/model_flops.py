"""Forward FLOPs of each model on the content alone (the phones and
frames a row really has, never its padding), for the whole step's share
of the chip's peak (``mfu``).  A product of an (m × k) by a (k × n) is
2·m·k·n; a conv of kernel k from C_in to C_out is 2·k·C_in·C_out a frame;
attention over T valid positions is 4·d·T² (QKᵀ and PV)."""

from roofline.vocoder_kernels import block_ops, stage_shapes


def fft_stack(layers, d, ffn, kernels, t) -> float:
    per_frame = 2 * 4 * d * d + 2 * kernels[0] * d * ffn + 2 * kernels[1] * ffn * d
    return layers * (per_frame * t + 4.0 * d * t * t)


def fastspeech2(f, n_emotions, n_mels, phones, frames) -> float:
    """Prenet, encoder, conditioning projection, the three predictors and
    the two embeddings over the phones; decoder and mel head over the
    frames.  The PostNet is left out: serving vocodes the mel before it."""
    d, ffn, k = f["d_model"], f["ffn_dim"], f["ffn_kernel_sizes"]
    vk = f["variance_kernel"]
    enc = (f["prenet_convs"] * 2 * f["prenet_kernel"] * d * d + 2 * d * d) * phones
    enc += fft_stack(f["enc_num_layers"], d, ffn, k, phones)
    enc += 2 * (2 * d + n_emotions) * d * phones
    enc += 3 * (2 * 2 * vk * d * d + 2 * d) * phones + 2 * 2 * vk * d * phones
    dec = fft_stack(f["dec_num_layers"], d, ffn, k, frames) + 2 * d * n_mels * frames
    return enc + dec


def hifigan(h, n_mels, frames) -> float:
    """conv_pre, the transposed convs, every ResBlock conv and conv_post
    over one row of ``frames`` mel frames."""
    c0 = h["upsample_initial_channel"]
    total = 2 * 7 * n_mels * c0 * frames
    c_in, t_in = c0, frames
    for (c, t), k_u in zip(stage_shapes(h, 1, frames), h["upsample_kernel_sizes"]):
        total += 2 * k_u * c_in * c * t_in
        total += sum(block_ops(c, t, 1, k, d) for k, d in
                     zip(h["resblock_kernel_sizes"], h["resblock_dilations"]))
        c_in, t_in = c, t
    return total + 2 * 7 * c_in * 1 * t_in


def extractor(e, n_in, n_emotions, frames) -> float:
    """The rank model's intensity extractor over one row of ``frames``."""
    d = e["hidden"]
    k = (e["kernel_size"], e["kernel_size"])
    return (2 * n_in * d * frames + fft_stack(e["layers"], d, e["ffn_dim"], k, frames)
            + 2 * d * n_emotions * frames)
