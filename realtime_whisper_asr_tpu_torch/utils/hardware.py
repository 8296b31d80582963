"""CUDA hardware detection and model recommendation.

Port of ``realtime_whisper_asr_tpu/utils/hardware.py``. Replaces the
reference's nvidia-smi/nvcc parsing (`一键实时识别麦克风.py:130-193`) and
VRAM-based model recommendation (:254-330) with ``torch.cuda``'s device
properties and memory-based sizing. The recommenders give the JAX package's
answers for the same memory size, with ``"gpu"`` where it reads ``"tpu"``.
The JAX module's tunnel probe and degraded CPU plan are not ported: the
port's entry points raise without CUDA instead of falling back.
"""

from __future__ import annotations

from typing import Any

# (model, est. weights GiB in bf16, note) — from the public size table the
# reference also surfaces (一键…py:258-263), halved for bf16 vs fp32.
MODEL_MEMORY_GIB = {
    "tiny": 0.08,
    "base": 0.15,
    "small": 0.5,
    "medium": 1.6,
    "large-v3": 3.2,
    "large-v3-turbo": 1.7,
}


#: a host without CUDA, or a CPU session (``cli wizard --cpu``)
CPU = {"platform": "cpu", "device_kind": "cpu", "n_devices": 1, "hbm_bytes": None}


def detect_hardware() -> dict[str, Any]:
    """The first CUDA card's name, count, compute capability and memory
    (``hbm_bytes``, the key the recommenders read); ``platform`` ``"cpu"``
    with no memory figure on a host without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return dict(CPU)
    props = torch.cuda.get_device_properties(0)
    return {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(0),
        "n_devices": torch.cuda.device_count(),
        "compute_capability": f"{props.major}.{props.minor}",
        "hbm_bytes": props.total_memory,
    }


def recommend_config(hw: dict[str, Any]) -> dict[str, Any]:
    """Pick the largest model whose weights + KV + activations fit comfortably."""
    hbm = hw.get("hbm_bytes") or 0
    gib = hbm / 2**30 if hbm else 0
    if hw.get("platform") != "gpu":
        return {"model": "tiny", "dtype": "float32", "reason": "no CUDA card"}
    for model in ("large-v3", "medium", "small", "base", "tiny"):
        need = MODEL_MEMORY_GIB.get(model, 1e9) * 3  # weights + cache + headroom
        if gib >= need:
            return {"model": model, "dtype": "bfloat16",
                    "reason": f"{gib:.0f} GiB device memory ≥ {need:.1f} GiB needed"}
    return {"model": "tiny", "dtype": "bfloat16", "reason": "minimal device memory"}


def recommend_separation_config(hw: dict[str, Any], model: str,
                                music_expected: bool = False,
                                streams: int = 1) -> dict[str, Any]:
    """Separation-method recommendation (reference recommend_demucs_config,
    `一键实时识别麦克风.py:332-430`: VRAM tiers → demucs variant or filter).

    Card tiers: the on-device ``neural`` spectral-mask separator costs one
    extra small model in device memory; ``filter`` (band-pass) is the
    reference's shipped default; ``none`` when no music is expected (the gate
    the reference wizard asks about at :771-789).
    """
    if not music_expected:
        return {"method": "none",
                "reason": "no background music expected; separation off saves latency"}
    hbm = hw.get("hbm_bytes") or 0
    gib = hbm / 2**30 if hbm else 0
    model_gib = MODEL_MEMORY_GIB.get(model, 3.2)
    if hw.get("platform") != "gpu":
        # a CPU session: the small host-path variant is affordable where the
        # full net eats the realtime budget next to a CPU decode
        return {"method": "neural", "variant": "small", "use_device": False,
                "reason": "CPU session: small host-path mask net beats band-pass "
                          "quality at a filter-like cost"}
    if streams > 4:
        # fused separation rides the batched tick encode, so the per-stream
        # cost is device compute only; the small variant keeps that prologue
        # cheap at high batch
        return {"method": "neural", "variant": "small", "fuse_encode": True,
                "reason": f"{streams} concurrent streams: small mask net "
                          "fused into the batched tick encode (zero host "
                          "cost per stream)"}
    if gib >= model_gib * 3 + 1:
        return {"method": "neural", "variant": "default", "fuse_encode": True,
                "reason": f"{gib:.0f} GiB device memory leaves headroom for the "
                          "trained spectral-mask separator fused into the "
                          "encode (best quality, zero host cost)"}
    return {"method": "filter",
            "reason": "tight memory: 85-3400 Hz band-pass (reference default)"}


def recommend_quantization(hw: dict[str, Any], model: str) -> dict[str, Any]:
    """Quantization recommendation (reference int8-on-CPU advice,
    `一键实时识别麦克风.py:300-328`): **int8-all** (decoder + encoder +
    logits head) for ≥medium models, whose batch-1 decode reads every weight
    once a token; small models stay bf16."""
    if model in ("medium", "large-v2", "large-v3", "large-v3-turbo"):
        return {"quantization": "int8-all",
                "reason": "batch-1 decode reads every weight once a token: int8 "
                          "weights halve those bytes (plain int8 keeps the "
                          "encoder in bf16 if conservative)"}
    return {"quantization": None,
            "reason": f"{model} decode is not bandwidth-limited; bf16 keeps full quality"}
