"""Whisper weights made from the seed, on the device, in a few large calls.

The benchmark makes the weights and hands the same dense tensors to the
program (which quantizes them to its tier) and, made again from the same
seed after the window, to the plain reference (which quantizes them itself).
The keys and layouts are a dense Whisper's state dict in torch's (out, in)
layout with the self-attention's q, k and v fused into ``attn.qkv`` (k
without a bias, as Whisper's key projection has none): what the program's
``params=`` takes, and what the reference reads.

Distributions: linear and conv weights N(0, 1/fan_in), the token embedding
N(0, 0.02^2), decoder positions N(0, 0.01^2), biases N(0, 0.02^2), layer-norm
gains 1 + N(0, 0.05^2) and shifts N(0, 0.02^2), the encoder's sinusoidal
positions. All normals come from two draws of one ``torch.Generator`` on the
device: one for the matrices, one for the vectors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions, (length, channels) f32."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def layout(cfg: dict) -> tuple[list, list]:
    """([(key, shape, std)] of the matrices, [(key, shape, kind)] of the
    vectors) of a dense Whisper of configuration ``cfg`` (the benchmark's
    config keys). kind: "bias", "gain", "shift" or "kbias" (zero)."""
    d, dt = cfg["d_model"], cfg["d_model"]
    mats, vecs = [], []

    def linear(name, d_in, d_out, bias=True):
        mats.append((f"{name}.weight", (d_out, d_in), d_in ** -0.5))
        if bias:
            vecs.append((f"{name}.bias", (d_out,), "bias"))

    def ln(name, width):
        vecs.append((f"{name}.weight", (width,), "gain"))
        vecs.append((f"{name}.bias", (width,), "shift"))

    n_mels = cfg["num_mel_bins"]
    mats.append(("encoder.conv1.weight", (d, n_mels, 3), (n_mels * 3) ** -0.5))
    vecs.append(("encoder.conv1.bias", (d,), "bias"))
    mats.append(("encoder.conv2.weight", (d, d, 3), (d * 3) ** -0.5))
    vecs.append(("encoder.conv2.bias", (d,), "bias"))
    ffn = cfg["encoder_ffn_dim"]
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.blocks.{i}"
        ln(f"{p}.attn_ln", d)
        mats.append((f"{p}.attn.qkv.weight", (3 * d, d), d ** -0.5))
        vecs.append((f"{p}.attn.qkv.bias", (3 * d,), "kbias"))
        linear(f"{p}.attn.out", d, d)
        ln(f"{p}.mlp_ln", d)
        linear(f"{p}.fc1", d, ffn)
        linear(f"{p}.fc2", ffn, d)
    ln("encoder.ln_post", d)
    mats.append(("decoder.tok_emb", (cfg["vocab_size"], dt), 0.02))
    mats.append(("decoder.pos_emb", (cfg["max_target_positions"], dt), 0.01))
    ffn = cfg["decoder_ffn_dim"]
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.blocks.{i}"
        ln(f"{p}.attn_ln", dt)
        mats.append((f"{p}.attn.qkv.weight", (3 * dt, dt), dt ** -0.5))
        vecs.append((f"{p}.attn.qkv.bias", (3 * dt,), "kbias"))
        linear(f"{p}.attn.out", dt, dt)
        ln(f"{p}.cross_ln", dt)
        linear(f"{p}.cross.query", dt, dt)
        linear(f"{p}.cross.key", d, dt, bias=False)
        linear(f"{p}.cross.value", d, dt)
        linear(f"{p}.cross.out", dt, dt)
        ln(f"{p}.mlp_ln", dt)
        linear(f"{p}.fc1", dt, ffn)
        linear(f"{p}.fc2", ffn, dt)
    ln("decoder.ln", dt)
    return mats, vecs


def make_state(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The dense state dict of ``cfg`` from ``seed``, every tensor in
    ``dtype`` on ``device`` (views into two flat buffers)."""
    mats, vecs = layout(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    n_mat = sum(math.prod(shape) for _, shape, _ in mats)
    n_vec = sum(math.prod(shape) for _, shape, _ in vecs)
    flat = torch.randn(n_mat, generator=gen, device=device, dtype=dtype)
    flat_v = torch.randn(n_vec, generator=gen, device=device, dtype=dtype)
    state, off = {}, 0
    for key, shape, std in mats:
        n = math.prod(shape)
        state[key] = flat[off: off + n].view(shape).mul_(std)
        off += n
    off = 0
    for key, shape, kind in vecs:
        n = math.prod(shape)
        t = flat_v[off: off + n].view(shape)
        off += n
        if kind == "gain":
            t.mul_(0.05).add_(1.0)
        elif kind == "kbias":  # q | k | v: the key's third is zero
            t.mul_(0.02)
            t[shape[0] // 3: 2 * shape[0] // 3].zero_()
        else:
            t.mul_(0.02)
        state[key] = t
    state["encoder.pos_emb"] = torch.from_numpy(
        sinusoids(cfg["max_source_positions"], cfg["d_model"])).to(device, dtype)
    return state
