"""Serving export: the flip-TTA DDIM eval step as a ``torch.export``
artifact. Port of ``diff3dhpe_tpu/io/export.py``.

The artifact holds the whole eval step of the runner's eval mode (the
plain or ``use_pallas`` module, the fused forward at float32 or bf16, the
mixed mode with or without its float32 tail): the DDIM loop, the
flip-TTA doubling and average. The kernels are the ``diff3dhpe::``
operators (``ops._library``), each with a CPU and a CUDA implementation,
so the artifact runs the kernels on the card, or their plain versions on
the CPU. It runs on the device it was exported on, and on any other of the
``platforms`` its export names ("cpu", "cuda"; JAX's lowering platforms,
:37): ``restore_eval_step(path, device=...)`` moves the program there
(``move_to_device_pass``). The mixed step records the contraction mode of
its float32 final step (``final_prec``), and every step records the session
matmul precision of its float32 products outside the fused blocks
(``matmul_precision``), which is baked into the traced program as JAX bakes
it into its trace. The trained weights are runtime
INPUTS, under the reference's state-dict names, so one artifact serves
every checkpoint of its shape; the bf16 copies of the bf16 paths are made
inside the graph, once per call.

    data = export_eval_step(runner, batch_size=4, path="eval.pt2")
    # ... serving process ...
    step = restore_eval_step("eval.pt2")
    pred_norm = step(state_dict, x2d, x2d_flip, x_init)   # [B, F_out, J, 3]

x_T (``x_init``, 2 · B · repeat_n rows with flip-TTA, ordered as
``engine.steps.make_eval_step`` takes it) is an input, where JAX's artifact
takes a PRNG key and draws it inside: torch cannot draw JAX's keyed noise,
and every other path of the port takes x_T too. Where
``ddim_sampling_eta`` > 0 the per-step noise ``noises`` [S, rows, F_out, J,
3] is a fifth input. CLI front end: ``python -m diff3dhpe_torch.cli.export``.

``sharded=True`` (JAX: the mesh-bound ``shard_map`` program, :53-72)
exports the per-rank step of a run of ``mesh_shape`` "data:N,model:M" at
the local batch B / N; its metadata records the world size N·M, both axis
sizes and the global batch B. Under a model axis > 1 the step is traced,
as the live fused eval runs, on the whole module of the gathered weights,
which enter the artifact whole (as JAX's ``P()`` parameters do). Restored
in a run of the same mesh shape (``restore_eval_step(path, mesh)``, each
rank's mesh laid out as the export's), the step takes the global inputs,
runs the rank's data rows and gathers the prediction in global order on
every rank; restored under another mesh shape (another world size, or the
same one laid out otherwise), or in one process, it raises a ValueError
naming both shapes. JAX's ``nr_devices`` check counts devices only; the
port's per-rank batch B / N depends on the layout.

From a tensor-parallel runner the one-process export traces the same whole
module (JAX's default ``sharded=False``, :74-81), so the artifact is the
one a single process exports.
"""
from __future__ import annotations

import io
import json
import os
from typing import Union

import torch

META = "diff3dhpe_eval_step.json"
# The device types an artifact can name as its platforms.
PLATFORMS = ("cpu", "cuda")


def check_platforms(platforms, device, field="platforms"):
    """``platforms`` (a list of device types, or None for ``device``'s
    type alone) checked: each one of ``PLATFORMS``, and ``device``'s type
    among them. Returns the list; a ValueError names ``field`` otherwise."""
    export_type = torch.device(device).type
    if platforms is None:
        return [export_type]
    platforms = list(dict.fromkeys(platforms))
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"{field}={platforms!r} is not taken: an artifact runs on {PLATFORMS}")
    if export_type not in platforms:
        raise ValueError(f"{field}={platforms!r} does not name {export_type!r}, the device this "
                         "artifact is exported on")
    return platforms


def live_eval_step(runner, temporal_mode: str = "rows", model=None):
    """The eval step that ``export_eval_step`` exports, live, in one
    process: the runner's own ``eval_step`` in "rows" (without its mesh),
    the same in "cols"; on ``model`` (default ``runner.model``), a whole
    module."""
    import dataclasses

    from diff3dhpe_torch.engine.runner import eval_diffusion
    from diff3dhpe_torch.engine.steps import make_denoise_fn, make_eval_step

    cfg = runner.cfg
    model = runner.model if model is None else model
    diffusion = dataclasses.replace(runner.diffusion,
                                    denoise_fn=make_denoise_fn(model, cfg.matmul_precision))
    return make_eval_step(eval_diffusion(cfg, diffusion, model, temporal_mode),
                          runner.joints_left, runner.joints_right, repeat_n=cfg.repeat_n,
                          tta=cfg.test_time_augmentation, device=runner.device)


class _EvalStep(torch.nn.Module):
    """``live_eval_step`` on ``self.model``'s weights as they are at each
    call: the sampler is built inside ``forward``, so the bf16 snapshot's
    casts are part of the traced graph."""

    def __init__(self, runner, temporal_mode, model):
        super().__init__()
        self.model = model
        self.runner, self.temporal_mode = runner, temporal_mode

    def forward(self, input_2d, input_2d_flip, x_init, noises=None):
        step = live_eval_step(self.runner, self.temporal_mode, self.model)
        return step(input_2d, input_2d_flip, x_init=x_init, noises=noises)


class _Serving(torch.nn.Module):
    """What is exported: forward(state, input_2d, input_2d_flip, x_init[,
    noises]), the weights ``state`` handed to ``_EvalStep`` by
    ``functional_call``. The step is no submodule, so the artifact holds no
    weights."""

    def __init__(self, step):
        super().__init__()
        object.__setattr__(self, "step", step)

    def forward(self, state, *inputs):
        params = {f"model.{k}": v for k, v in state.items()}
        return torch.func.functional_call(self.step, params, inputs, strict=True)


def _inputs(runner, batch_size):
    """Example inputs of the exported signature, at their fixed shapes."""
    cfg, dev = runner.cfg, runner.device
    f, j = cfg.number_of_frames, runner.num_joints
    rows = batch_size * cfg.repeat_n * (2 if cfg.test_time_augmentation else 1)
    x_shape = (rows, f if cfg.out_all else 1, j, 3)
    x2d = torch.zeros(batch_size, f, j, 2, device=dev)
    inputs = [x2d, x2d.clone(), torch.zeros(x_shape, device=dev)]
    if cfg.ddim_sampling_eta:
        inputs.append(torch.zeros((cfg.sampling_timesteps,) + x_shape, device=dev))
    return inputs


def export_eval_step(runner, batch_size: int, path: str = None, *, sharded: bool = False,
                     temporal_mode: str = "rows", platforms=None) -> bytes:
    """Serializes ``runner``'s eval step at batch ``batch_size``: the
    artifact's bytes, also written to ``path`` if given. ``runner``: an
    ``engine.runner.Runner``, or anything with its ``cfg``, ``model``,
    ``diffusion``, ``device``, ``num_joints``, ``joints_left`` and
    ``joints_right``. ``temporal_mode``: the fused forward's temporal
    layout, "rows" (the runner's) or "cols". ``platforms``: the device
    types ("cpu", "cuda") the artifact may be restored on, recorded in its
    metadata; they must name the runner's device's type, which alone is
    the default.

    The signature is step(state, input_2d, input_2d_flip, x_init[, noises])
    -> predicted_3d_norm [B, F_out, J, 3], ``make_eval_step``'s
    single-device contract (flip-TTA averaged, normalised units). ``state``
    is a state dict of the runner's model (its weights only shape the
    export).

    ``sharded=True``: the per-rank step of the runner's run across
    processes (``runner.mesh``, which it needs, "data:N,model:M") at
    ``batch_size`` / N rows, which must divide (a ValueError, "does not
    divide", otherwise); the artifact is restored in a run of the same
    mesh shape (``restore_eval_step``). In a run across processes rank 0
    alone traces and writes the artifact, and the other ranks wait for it
    and return None; a tensor-parallel runner's ranks first gather the
    whole weights (module doc). A fused eval step refuses a module with
    ``qk_scale`` or dropout (``models.fast_eval.check_fused``)."""
    from diff3dhpe_torch.models.fast_eval import check_fused

    mesh = getattr(runner, "mesh", None)
    platforms = check_platforms(platforms, runner.device)
    if sharded and mesh is None:
        raise ValueError("sharded=True exports the per-rank step of a data-parallel run (or "
                         "a tensor-parallel one): build the runner with its DataMesh "
                         "(Runner(mesh=...); the CLI under torchrun with --mesh-shape data:N or "
                         "data:N,model:M)")
    local = batch_size
    if sharded:
        rows = mesh.rows(batch_size)
        local = rows.stop - rows.start
    full = getattr(runner, "full_model", None)
    model = runner.model if full is None else full()  # collective under tensor parallelism
    if runner.cfg.fast_eval:  # on every rank, before rank 0 alone traces
        check_fused(model)
    if mesh is not None and not mesh.is_main:
        mesh.barrier()
        return None
    state = {k: v.detach() for k, v in model.state_dict().items()}
    inputs = _inputs(runner, local)
    with torch.no_grad():
        program = torch.export.export(_Serving(_EvalStep(runner, temporal_mode, model)),
                                      (state, *inputs),
                                      strict=False)
    # The example inputs would be saved with the program: the weights too.
    program.example_inputs = None
    cfg = runner.cfg
    mixed = cfg.fast_eval and cfg.compute_dtype == "bfloat16" and cfg.eval_f32_final_steps > 0
    meta = dict(keys=list(state), device=str(runner.device), platforms=platforms,
                final_prec=cfg.eval_final_prec if mixed else None,
                matmul_precision=cfg.matmul_precision, batch_size=local,
                sharded=dict(world_size=mesh.size, data=mesh.data_size, model=mesh.model_size,
                             global_batch=batch_size) if sharded else None,
                temporal_mode=temporal_mode,
                num_frames=cfg.number_of_frames, num_joints=runner.num_joints,
                noises=bool(cfg.ddim_sampling_eta),
                input_shapes=[list(t.shape) for t in inputs])
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META: json.dumps(meta)})
    data = buf.getvalue()
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    if mesh is not None:
        mesh.barrier()
    return data


def _mesh_shape(sizes) -> str:
    """The words for a mesh shape (data N, model M): its ``mesh_shape``
    and rank count, or one process where there is none."""
    if not sizes:
        return "one process"
    data, model = sizes
    return f"mesh_shape 'data:{data},model:{model}' ({data * model} rank(s))"


def restore_eval_step(artifact: Union[str, bytes, bytearray], mesh=None, device=None):
    """Loads an exported eval step (a path or the bytes) -> step(state,
    input_2d, input_2d_flip, x_init[, noises]).

    ``state`` is a state dict under the reference's names, as
    ``load_state_dict(strict=True)`` takes it (a missing or unexpected key
    raises a KeyError naming it); its tensors, and the inputs (tensors or
    arrays), are moved to the step's device: ``device``, or the device the
    artifact was exported on. ``device`` must be of a type among the
    artifact's ``platforms`` (a ValueError names it otherwise); the program
    is moved there. The inputs must have the export's shapes. Runs without
    autograd.

    A sharded artifact is restored in a run of the mesh shape it was
    exported for ("data:N,model:M"), each rank passing its ``mesh`` of that
    layout; the step then takes the global inputs (the export's global
    batch) and the whole state dict, runs on ``mesh.device`` the rank's
    data rows (x_T's and ``noises``' as ``make_eval_step`` slices them) and
    returns the prediction gathered in global order. The mesh shape (none
    for an artifact that is not sharded, and without ``mesh``) must be the
    artifact's: a ValueError names both otherwise."""
    import diff3dhpe_torch.ops  # noqa: F401 (registers the diff3dhpe:: operators)

    extra = {META: ""}
    src = io.BytesIO(bytes(artifact)) if isinstance(artifact, (bytes, bytearray)) else artifact
    program = torch.export.load(src, extra_files=extra)
    meta = json.loads(extra[META])
    sharded = meta.get("sharded")
    want = _mesh_shape(None if not sharded else (sharded.get("data", sharded["world_size"]),
                                                 sharded.get("model", 1)))
    have = _mesh_shape(None if mesh is None else (mesh.data_size, mesh.model_size))
    if want != have:
        batch = sharded["global_batch"] if sharded else meta["batch_size"]
        raise ValueError(f"this eval step was exported for {want} (global batch {batch}) and is "
                         f"restored {'in' if mesh is None else 'under'} {have}: restore it in a "
                         f"run of that mesh shape, passing each rank's DataMesh of that layout")
    keys, dev = meta["keys"], torch.device(meta["device"])
    platforms = meta.get("platforms") or [dev.type]
    if device is not None and torch.device(device).type not in platforms:
        raise ValueError(f"device={str(device)!r} is not among this artifact's platforms "
                         f"{platforms}: export it with platforms naming {torch.device(device).type!r}"
                         " (cli.export --export-platforms)")
    target = torch.device(device) if device is not None else (
        mesh.device if mesh is not None else dev)
    if target != dev:
        # Exported on another device (rank 0's, or another platform's).
        from torch.export.passes import move_to_device_pass

        program, dev = move_to_device_pass(program, str(target)), target
    module = program.module()

    def step(state, input_2d, input_2d_flip, x_init, noises=None):
        missing = [k for k in keys if k not in state]
        unexpected = [k for k in state if k not in set(keys)]
        if missing or unexpected:
            raise KeyError(f"state does not fit the artifact: missing {missing[:5]}, "
                           f"unexpected {unexpected[:5]}")
        if (noises is not None) != meta["noises"]:
            raise ValueError("noises is an input exactly where ddim_sampling_eta > 0 "
                             f"(this artifact: {'with' if meta['noises'] else 'without'})")
        params = {k: torch.as_tensor(state[k], device=dev) for k in keys}
        inputs = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (input_2d, input_2d_flip, x_init, noises) if a is not None]
        if mesh is not None:
            b = sharded["global_batch"]
            rows = mesh.rows(b)
            inputs = [inputs[0][rows], inputs[1][rows], mesh.shard(inputs[2], b),
                      *(mesh.shard(a, b, dim=1) for a in inputs[3:])]
        with torch.no_grad():
            out = module(params, *inputs)
        return out if mesh is None else mesh.gather_rows(out)

    step.meta = meta
    return step
