"""The port's native checkpoint format: the deployment artifact.

Port of ``realtime_whisper_asr_tpu/models/whisper/checkpoint.py``. The JAX
package keeps its params with orbax, a JAX library the port may not import,
so the port has a format of its own:

- ``rtwa_config.json``: the architecture, the fields of
  ``dataclasses.asdict(WhisperConfig)`` (the JAX package's file of the same
  name);
- ``rtwa_torch.safetensors``: the state dict of ``model.Whisper``, dense or
  pre-quantized by a tier (``quant.quantize``), written by the port's own
  safetensors writer (``safetensors_io``).

A directory with ``rtwa_config.json`` and orbax's ``params/`` but no
``rtwa_torch.safetensors`` is the JAX package's native checkpoint: loading
it raises and names the conversion.

Train states (``save_train_state`` / ``load_train_state``, the JAX module's
orbax ones in the port's format): ``train_state.safetensors`` holds every
tensor of a ``train.TrainState`` (the params, the optimizer's moments) under
its path in the state's tree, and ``train_state.json`` the rest (the step,
the optimizer's counts).

Under a mesh (``parallel.Mesh`` or a pipeline's ``StageMesh``): each rank
writes its own state's pair of files (``train_state.rank<r>.*``) and rank
0 a manifest of the mesh's shape (``mesh.json``); a resume reads its rank's
files into a template of the same mesh shape, and any other shape (or a
state saved without a mesh) raises. ``load_checkpoint_sharded`` reads a
native checkpoint straight into a mesh's tensor-parallel layout: each rank
copies its slices of the mapped file and nothing else.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig
from realtime_whisper_asr_tpu_torch.models.whisper.safetensors_io import (
    read_safetensors,
    write_safetensors,
)

_CONFIG_FILE = "rtwa_config.json"
_STATE_FILE = "rtwa_torch.safetensors"
_ORBAX_DIR = "params"


def save_checkpoint(path: str, state: dict, cfg: WhisperConfig) -> int:
    """Write ``state`` (a state dict of ``model.Whisper``, on any device) and
    ``cfg`` as a native checkpoint under ``path``, tensor by tensor. Returns
    the bytes of the state file."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _CONFIG_FILE), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    return write_safetensors(os.path.join(path, _STATE_FILE), state)


def _cast_floats(state: dict, dtype) -> dict:
    """Cast float tensors to ``dtype``, EXCEPT the f32 scales of quantized
    weights (``name.s`` beside ``name.q``): a bf16 scale would dequantize to
    other weights than the quantization the checkpoint was saved from."""
    out = {}
    for key, t in state.items():
        scale = key.endswith(".s") and key[:-1] + "q" in state
        out[key] = t.to(dtype) if t.is_floating_point() and not scale else t
    return out


def is_native_checkpoint(path: str) -> bool:
    """A native checkpoint of either package: ``rtwa_config.json`` present."""
    return os.path.exists(os.path.join(path, _CONFIG_FILE))


def load_checkpoint(path: str, dtype=None) -> tuple[WhisperConfig, dict]:
    """(config, state dict as CPU tensors) of a native checkpoint; the
    floats cast to ``dtype`` when given, the scales of quantized weights kept
    f32. Raises ``ValueError`` for the JAX package's orbax checkpoint."""
    with open(os.path.join(path, _CONFIG_FILE)) as f:
        cfg = WhisperConfig(**json.load(f))
    state = _read_state(path)
    return cfg, (state if dtype is None else _cast_floats(state, dtype))


def _read_state(path: str) -> dict:
    """The state file of a native checkpoint (a mapped view); raises
    ``ValueError`` for the JAX package's orbax checkpoint."""
    state_file = os.path.join(path, _STATE_FILE)
    if not os.path.exists(state_file):
        if os.path.isdir(os.path.join(path, _ORBAX_DIR)):
            raise ValueError(
                f"{path} is the JAX package's orbax checkpoint ({_ORBAX_DIR}/), which the port "
                f"cannot read. Convert it where the JAX package is installed: "
                f"realtime_whisper_asr_tpu.models.whisper.checkpoint.load_checkpoint, then "
                f"realtime_whisper_asr_tpu_torch.models.whisper.convert.params_from_jax, then "
                f"this module's save_checkpoint")
        raise FileNotFoundError(f"{path} has {_CONFIG_FILE} but no {_STATE_FILE}")
    return read_safetensors(state_file)


def load_checkpoint_sharded(path: str, mesh, dtype=None) -> tuple[WhisperConfig, dict]:
    """(config, this rank's shards) of a native checkpoint in the mesh's
    tensor-parallel layout (``parallel.sharding``): each tensor's slice is
    copied out of the mapped file, so no rank reads or holds the whole
    model. Floats cast to ``dtype`` when given (quantized scales kept f32).
    ``parallel.sharding.shard_model(state, cfg, mesh, local=True)`` builds
    the model over them."""
    from realtime_whisper_asr_tpu_torch.parallel.sharding import shard_tensor, split_of

    with open(os.path.join(path, _CONFIG_FILE)) as f:
        cfg = WhisperConfig(**json.load(f))
    state = {k: shard_tensor(v, split_of(k)[0], mesh.model_rank, mesh.model).clone()
             for k, v in _read_state(path).items()}
    return cfg, (state if dtype is None else _cast_floats(state, dtype))


# ---------------------------------------------------------------------------
# train states (resumable fine-tuning runs)
# ---------------------------------------------------------------------------

_TRAIN_TENSORS = "train_state.safetensors"
_TRAIN_META = "train_state.json"
_MESH_FILE = "mesh.json"


def _train_files(mesh) -> tuple[str, str]:
    """(tensor file, JSON file) of this rank's train state."""
    if mesh is None:
        return _TRAIN_TENSORS, _TRAIN_META
    return f"train_state.rank{mesh.rank}.safetensors", f"train_state.rank{mesh.rank}.json"


def _leaves(node, path: str, tensors: dict, meta: dict) -> None:
    """Walk a train state (tuples, NamedTuples, dataclasses, dicts; tensor
    and int leaves): tensors into ``tensors``, ints into ``meta``, by path."""
    if isinstance(node, torch.Tensor):
        tensors[path] = node
    elif isinstance(node, int):
        meta[path] = node
    elif isinstance(node, dict):
        for k, v in node.items():
            _leaves(v, f"{path}/{k}", tensors, meta)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            _leaves(getattr(node, f.name), f"{path}/{f.name}", tensors, meta)
    elif isinstance(node, tuple):
        fields = getattr(node, "_fields", None)
        for k, v in zip(range(len(node)) if fields is None else fields, node):
            _leaves(v, f"{path}/{k}", tensors, meta)
    else:
        raise TypeError(f"train state leaf {path}: {type(node).__name__}")


def save_train_state(path: str, state, mesh=None) -> int:
    """Persist a ``train.TrainState`` (params + optimizer moments and
    counts + step) under ``path``; returns the tensor file's bytes. Under
    ``mesh`` every rank writes its own files and rank 0 the mesh's shape;
    every rank returns once all have written."""
    tensors, meta = {}, {}
    _leaves(state, "", tensors, meta)
    os.makedirs(path, exist_ok=True)
    tensor_file, meta_file = _train_files(mesh)
    with open(os.path.join(path, meta_file), "w") as f:
        json.dump(meta, f, indent=1)
    n = write_safetensors(os.path.join(path, tensor_file), tensors)
    if mesh is not None:
        import torch.distributed as dist

        if mesh.rank == 0:
            with open(os.path.join(path, _MESH_FILE), "w") as f:
                json.dump({"shape": mesh.shape}, f)
        dist.barrier()
    return n


def _restore(node, path: str, tensors: dict, meta: dict):
    if isinstance(node, torch.Tensor):
        with torch.no_grad():
            node.copy_(tensors[path])
        return node
    if isinstance(node, int):
        return meta[path]
    if isinstance(node, dict):
        return {k: _restore(v, f"{path}/{k}", tensors, meta) for k, v in node.items()}
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _restore(getattr(node, f.name), f"{path}/{f.name}", tensors, meta)
            for f in dataclasses.fields(node)})
    fields = getattr(node, "_fields", None)  # a NamedTuple's, else a plain tuple
    values = [_restore(v, f"{path}/{k}", tensors, meta)
              for k, v in zip(range(len(node)) if fields is None else fields, node)]
    return tuple(values) if fields is None else type(node)(*values)


def load_train_state(path: str, template_state, mesh=None):
    """Resume a training run: restore into a freshly built template
    (``train.make_train_state`` with the same optimizer), tensor by tensor
    in place, so every leaf keeps the template's device, dtype and
    ``requires_grad``; the counts and the step from the JSON. A leaf the
    file lacks raises ``KeyError``. Under ``mesh``, this rank's files of a
    state saved on a mesh of the same shape; another shape, or a state
    saved with a mesh where none is given (or the reverse), raises
    ``ValueError``."""
    manifest = os.path.join(path, _MESH_FILE)
    saved = None
    if os.path.exists(manifest):
        with open(manifest) as f:
            saved = json.load(f)["shape"]
    here = None if mesh is None else dict(mesh.shape)
    if saved != here:
        raise ValueError(f"{path} holds a train state saved on mesh {saved}; it cannot resume "
                         f"on mesh {here}")
    tensor_file, meta_file = _train_files(mesh)
    with open(os.path.join(path, meta_file)) as f:
        meta = json.load(f)
    tensors = read_safetensors(os.path.join(path, tensor_file))
    return _restore(template_state, "", tensors, meta)
