"""Ahead-of-time export of a warm predictor for serving (``torch.export``).

Port of ``tmv_tpu/serving/export.py``. The predict path that ``DetectionService``
calls (forward, decode and class-aware NMS: ``YoloPredictCore`` or
``EfficientDetPredictCore``, the ``.core`` of the harnesses' predictors) is traced
by ``torch.export`` into an ``ExportedProgram``, saved with ``torch.export.save``
inside the JAX package's tar layout: ``MAGIC``, ``BAKED``, ``META`` and, in place
of ``fn.stablehlo``, ``program.pt2``. A server then needs torch, this module and the
kernel modules, not the model zoo (``cli/serve.py --artifact``).

- The hand-written kernels are ``torch.library`` custom ops (``tmv::nms_sweep``,
  ``tmv::dw_bn_swish``, ``tmv::int8_conv``, ``tmv::int8_dwconv``): the program holds
  the ops, not a traced plain version, and each op picks its implementation by the
  device it runs on (the kernel on the card, the plain version on the CPU). Loading
  imports the kernel modules, which register the ops.
- The program is stored on the CPU and moved to the device it is loaded for
  (``torch.export.passes.move_to_device_pass``), so one artifact loads on every
  device of its ``platforms`` (``("cuda", "cpu")`` by default), on a host without a
  card too.
- ``bake_variables=True`` holds the weights (and an int8 model's non-persistent
  site buffers) in the program. Unbaked, the program takes the model's
  ``state_dict`` as ``variables`` at call time (through ``torch.func.functional_call``)
  and stores no weight; what is not in the ``state_dict`` (the int8 sites' buffers,
  the anchors) is still held as a constant.
- The input's shape and dtype are fixed at export and recorded in ``META``.
"""

import io
import json
import os
import tarfile
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

MAGIC = "tmv-torch-export-v1"
JAX_MAGIC = "tmv-export-v1"      # tmv_tpu/serving/export.py's StableHLO artifacts
PROGRAM = "program.pt2"


class _Unbaked(torch.nn.Module):
    """``forward(weights, images)``: the core with its model's ``state_dict`` given as
    a list of tensors in ``names`` order. The core is held outside the module tree, so
    that ``torch.export`` lifts none of its weights into the program."""

    def __init__(self, core: torch.nn.Module, names):
        super().__init__()
        self._core = [core]
        self.names = list(names)

    def forward(self, weights, images):
        state = {"model." + name: w for name, w in zip(self.names, weights)}
        return torch.func.functional_call(self._core[0], state, (images,))


def _core_of(predict_fn) -> torch.nn.Module:
    return predict_fn if isinstance(predict_fn, torch.nn.Module) else predict_fn.core


def _read_tar(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    return tarfile.open(fileobj=io.BytesIO(raw))


def export_predictor(predict_fn, variables: Optional[Mapping[str, torch.Tensor]],
                     example_image: np.ndarray, path: Optional[str] = None,
                     bake_variables: bool = False, platforms=("cuda", "cpu"),
                     meta: Optional[dict] = None) -> bytes:
    """Serialize ``predict_fn`` (a predictor of the harnesses, or its ``.core``) to an
    artifact; returns its bytes and writes them to ``path`` if given.

    ``bake_variables`` holds the model's weights in the program (``variables`` must be
    None). Unbaked, ``variables`` (the model's ``state_dict``; None: its own) fixes
    only the names, shapes and types of what ``load_predictor``'s callable takes.
    The program is traced on the model's device from ``example_image`` (``(B, H, W,
    3)``, whose shape and dtype it pins). ``platforms`` lists the devices it may be
    loaded for; ``meta`` (JSON-serializable) is stored beside it with the input's
    shape and dtype."""
    unknown = set(platforms) - {"cuda", "cpu"}
    if unknown:
        raise ValueError(f"platforms {sorted(unknown)}: the port's programs run on cuda and cpu")
    if bake_variables and variables is not None:
        raise ValueError("a baked artifact holds the model's own weights: load them into "
                         "the model and pass variables=None")
    core = _core_of(predict_fn)
    model = core.model
    device = next(model.parameters()).device
    img = np.asarray(example_image)
    images = torch.as_tensor(img).to(device=device, dtype=torch.float32)
    from torch.export.passes import move_to_device_pass

    with torch.no_grad():
        if bake_variables:
            program = torch.export.export(core, (images,))
        else:
            state = model.state_dict() if variables is None else variables
            names = list(state)
            weights = [state[n].detach().to(device) for n in names]
            program = torch.export.export(_Unbaked(core, names), (weights, images))
    # the example inputs would be saved beside the program: the weights, unbaked
    program.example_inputs = None
    program = move_to_device_pass(program, "cpu")
    blob = io.BytesIO()
    torch.export.save(program, blob)

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        def add(name, data):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))

        add("MAGIC", MAGIC.encode())
        add("BAKED", b"1" if bake_variables else b"0")
        full_meta = dict(meta or {})
        full_meta.setdefault("input_shape", list(img.shape))
        full_meta.setdefault("input_dtype", str(img.dtype))
        full_meta.setdefault("platforms", list(platforms))
        if not bake_variables:
            full_meta["variables"] = names
        add("META", json.dumps(full_meta).encode())
        add(PROGRAM, blob.getvalue())
    out = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(out)
    return out


def load_program(path_or_bytes, platform: Optional[str] = None):
    """``(ExportedProgram on the CPU, baked, meta)`` of an artifact. Refuses a JAX
    artifact, any other magic and, where ``platform`` is given, an artifact whose
    ``platforms`` lack it, before reading the program. Registers the ``tmv::`` ops."""
    from tmv_tpu_torch.kernels import dwconv, int8_conv, nms_sweep  # noqa: F401 (the ops)

    with _read_tar(path_or_bytes) as tar:
        def read(name):
            try:
                member = tar.extractfile(name)
            except KeyError:
                member = None
            if member is None:
                raise ValueError(f"missing {name} in artifact")
            return member.read()

        magic = read("MAGIC").decode()
        if magic == JAX_MAGIC:
            raise ValueError(f"a JAX artifact (magic={magic!r}, a StableHLO program of "
                             "tmv_tpu.serving.export), not a tmv_tpu_torch one: serve it "
                             "with python -m tmv_tpu.cli.serve --artifact, or export the "
                             "model again with python -m tmv_tpu_torch.cli.export_model")
        if magic != MAGIC:
            raise ValueError(f"not a tmv_tpu_torch export artifact (magic={magic!r})")
        meta = json.loads(read("META").decode())
        if platform is not None and platform not in meta["platforms"]:
            raise ValueError(f"the artifact was exported for {meta['platforms']}, not "
                             f"{platform}")
        baked = read("BAKED") == b"1"
        program = torch.export.load(io.BytesIO(read(PROGRAM)))
    return program, baked, meta


def load_predictor(path_or_bytes, device="cuda") -> Callable:
    """Load an artifact on ``device`` → ``predict(variables, image)`` returning the
    live predictors' host numpy arrays (``DetectionService`` drives it unchanged).

    A baked artifact ignores ``variables`` (pass None); an unbaked one takes the
    model's ``state_dict``. ``device`` must be one of the artifact's ``platforms``;
    the ``tmv::`` ops run the kernels on the card and the plain versions on the CPU.
    The outputs keep the program's leading batch axis. ``predict.baked``,
    ``predict.meta`` and ``predict.program`` (the ``ExportedProgram`` on ``device``)
    say what was loaded."""
    from torch.export.passes import move_to_device_pass

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available (pass "
                           "device='cpu' to run on the CPU)")
    program, baked, meta = load_program(path_or_bytes, device.type)
    program = move_to_device_pass(program, device)
    module = program.module()
    names = meta.get("variables")

    def predict(variables: Any, image):
        images = torch.as_tensor(np.asarray(image)).to(device=device, dtype=torch.float32)
        with torch.inference_mode():
            if baked:
                outs = module(images)
            else:
                if variables is None:
                    raise ValueError("an unbaked artifact takes the model's state_dict as "
                                     "variables")
                outs = module([variables[n].to(device) for n in names], images)
            return tuple(t.cpu().numpy() for t in outs)

    predict.baked = baked
    predict.meta = meta
    predict.program = program
    return predict


def read_export_meta(path_or_bytes) -> dict:
    """The artifact's META dict (input shape and dtype, platforms, extras); ``{}``
    where it has none."""
    with _read_tar(path_or_bytes) as tar:
        try:
            member = tar.extractfile("META")
        except KeyError:
            return {}
        if member is None:
            return {}
        return json.loads(member.read().decode())


def export_file_size(path: str) -> int:
    return os.path.getsize(path)
