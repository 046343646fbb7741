"""Training step factory and loop with fault tolerance, on one device or
on a mesh.

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) function: the loss and its gradients by autograd
(through the plain attention and SSD paths, as the JAX package
differentiates them), optional microbatch gradient accumulation, gradient
clipping inside AdamW, and NaN-step skipping that needs no host sync.

``train_loop`` adds checkpoint/restart (resume from the latest valid
step), periodic async checkpointing and logging.  Its data iterator yields
NumPy (or tensor) batches, which the loop moves to the device.  A resumed
run restores the parameters and optimizer state, not the data position:
the iterator starts from its beginning, as in the JAX package.  It steps
through a :class:`TrainProgram`, the counterpart of the JAX
package's ``jit_train_step``: the step's in-place form
(``step_fn.in_place``: the gradients, then ``adamw_update_``, which writes
the parameters and moments over the old ones, as ``donate_argnums`` lets
XLA do), on CUDA captured in a CUDA graph and replayed, on the CPU run
eagerly.

With a mesh (``make_train_step(cfg, tcfg, mesh)``, ``train_loop(...,
mesh=mesh)``) the parameters and AdamW moments are DTensors placed by
``param_shardings(mode="train")`` (TP over ``model``, FSDP over the data
axes), batches by ``batch_spec``; the gradients are the same code on
DTensors, and the update runs K5 on each rank's local shards with the
gradient norm summed across ranks (``train/optimizer.py``).
``train_loop`` draws the parameters leaf by leaf onto their placements
(``init_params(..., mesh=)``, the JAX package's init under
``out_shardings``) and makes the moments on them, so no rank holds a
whole copy of the state, and steps the mesh through a
:class:`TrainProgram` too: ``step_fn.in_place`` writes each rank's shards
over the old ones, as the JAX package's ``jit_train_step`` does under
``in_shardings`` with ``donate_argnums``, and on CUDA over NCCL the whole
step (DTensor's redistributions, K5 on the local shards, the norm's
all-reduce, the metrics' reads) is captured in one CUDA graph.
``mesh=None`` keeps the single-device step as it was.  ``train_loop``
takes the mesh as a keyword (the JAX package passes it third, before the
data iterator) and raises ``TypeError`` on a mesh in the data iterator's
place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.kernels import adamw as K5
from repro_torch.launch.shardings import (batch_sharding, distribute,
                                          param_shardings, place_local)
from repro_torch.models.transformer import (ModelConfig, init_params, loss_fn,
                                          mesh_scope)
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, adamw_update_,
                                         norm_groups)


@dataclasses.dataclass
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    microbatches: int = 1            # gradient accumulation steps
    checkpoint_every: int = 100
    log_every: int = 10


def _value_and_grad(leaves, spec, cfg: ModelConfig, batch):
    """loss_fn's (total, metrics) at the parameters ``leaves`` (a flattened
    tree) and its gradients, one per leaf in the leaf's dtype.  On a mesh
    the backward runs in the forward's mesh scope too: the plain tensors
    autograd saved beside DTensors meet the gradients there."""
    live = [p.detach().requires_grad_() for p in leaves]
    with mesh_scope(live[0]):
        total, metrics = loss_fn(pytree.tree_unflatten(live, spec), cfg,
                                 batch)
        grads = torch.autograd.grad(total, live)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            list(grads))


def _microbatch(v, n: int, i: int):
    """Microbatch ``i`` of ``n`` along the leading axis.  A DTensor batch
    splits each rank's local rows, so microbatch ``i`` is rows ``i`` of
    every rank's shard: the same tokens over all ``n``, another grouping."""
    if isinstance(v, DTensor):
        loc = v.to_local()
        loc = loc.reshape(n, loc.shape[0] // n, *loc.shape[1:])[i]
        return DTensor.from_local(loc, v.device_mesh, v.placements,
                                  run_check=False)
    return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]


def place_batch(batch: dict, mesh) -> dict:
    """Batch tensors (the whole global batch on every rank) placed by
    ``batch_spec``: batch over the data axes."""
    return {k: v if isinstance(v, DTensor) else
            distribute_tensor(v, mesh, list(batch_sharding(mesh, v.dim())))
            for k, v in batch.items()}


def place_state(cfg: ModelConfig, params, opt_state, mesh, mode="train"):
    """Parameters and optimizer state placed by ``param_shardings``.  A
    leaf replicated over the whole mesh keeps its input's storage
    (``distribute_tensor`` does not copy it), so an in-place step writes
    that input too."""
    return (distribute(params, mesh,
                       param_shardings(params, mesh, mode, cfg)),
            distribute(opt_state, mesh,
                       param_shardings(opt_state, mesh, mode, cfg)))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """The train step: one device without a mesh; with one, on DTensor
    parameters and state (:func:`place_state`), plain batches placed by
    :func:`place_batch`.  ``step_fn(params, opt_state, batch) -> (params,
    opt_state, metrics)`` is functional, as the JAX package's;
    ``step_fn.in_place(params, opt_state, batch) -> metrics`` takes the
    same step and writes it over ``params`` and ``opt_state`` (on a mesh,
    over each rank's local shards); ``step_fn.gradients(params, batch) ->
    (loss, metrics, grads)`` is the step before its update, each gradient
    on its parameter's placements."""
    ocfg = tcfg.optimizer

    def gradients(params, batch):
        """(loss, metrics, gradient tree) at ``params``."""
        if mesh is not None:
            batch = place_batch(batch, mesh)
        leaves, spec = pytree.tree_flatten(params)
        n = tcfg.microbatches
        if n > 1:
            # split the batch on its leading axis; float32 gradient sums
            g_acc = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss_sum = 0.0
            for i in range(n):
                mb = {k: _microbatch(v, n, i) for k, v in batch.items()}
                total, _, grads = _value_and_grad(leaves, spec, cfg, mb)
                for a, g in zip(g_acc, grads):
                    a += g.float()
                loss_sum = loss_sum + total
            grads = [a / n for a in g_acc]
            loss = loss_sum / n
            metrics = {"loss": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
        else:
            loss, metrics, grads = _value_and_grad(leaves, spec, cfg, batch)
        if mesh is not None:
            # each gradient onto its parameter's placements: partial sums
            # over the data axes are reduced (and scattered, for FSDP)
            grads = [g if g.placements == p.placements else
                     g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        return loss, dict(metrics), pytree.tree_unflatten(grads, spec)

    def whole(metrics):
        # the whole values (a loss over a data-sharded batch is a partial
        # mean on each rank until it is reduced)
        return {k: v.full_tensor() if isinstance(v, DTensor) else v
                for k, v in metrics.items()}

    def step_fn(params, opt_state, batch):
        loss, metrics, grads = gradients(params, batch)
        # a step whose loss or gradient norm is not finite keeps the old
        # values, on the device (no host sync)
        new_params, new_opt, gnorm = adamw_update(grads, opt_state, params,
                                                  ocfg, loss=loss)
        metrics["grad_norm"] = gnorm
        return new_params, new_opt, whole(metrics)

    def in_place(params, opt_state, batch):
        loss, metrics, grads = gradients(params, batch)
        metrics["grad_norm"] = adamw_update_(grads, opt_state, params, ocfg,
                                             loss=loss)
        return whole(metrics)

    step_fn.in_place = in_place
    step_fn.gradients = gradients
    return step_fn


def batch_to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _backend(group, device_type: str) -> str:
    """The backend that runs ``device_type``'s tensors in ``group``
    (``None``: the default group)."""
    name = str(dist.get_backend(group))
    if ":" not in name:
        return name
    return dict(part.split(":") for part in name.split(",")).get(
        device_type, "none")


def _check_capturable(mesh) -> None:
    """Raise unless every group a CUDA mesh step communicates over (each
    mesh dimension's, for DTensor's redistributions, and the norm's, for
    K5's all-reduce) runs CUDA tensors on NCCL, whose collectives a CUDA
    graph captures."""
    dims = [mesh.get_group(d) for d in range(mesh.ndim)]
    for group in dims + norm_groups(mesh):
        name = _backend(group, "cuda")
        if name != "nccl":
            raise ValueError(
                f"TrainProgram: a mesh step on CUDA tensors communicates "
                f"over a {name} group, which a CUDA graph cannot capture; "
                f"a mesh on the card runs on NCCL")


class TrainProgram:
    """One train step over fixed buffers: the parameters and optimizer
    state it was given, which every step updates in place, and one batch
    buffer per key of ``batch``.

    The step is ``step_fn.in_place`` (:func:`make_train_step`): the
    gradients, then one ``adamw_update_`` that writes the new parameters
    and moments over the old ones (on the card one K5 call), so the step
    holds one copy of its state, as the JAX package's donated step does;
    the NaN-skip stays on the device.  On CUDA the first :meth:`step` runs
    eagerly on a side stream (the warm-up, a real step; on a mesh it also
    starts the NCCL communicators) and then captures one step in a
    ``torch.cuda.CUDAGraph`` (whose entry empties the allocator's cache of
    the warm-up's freed blocks), which every later step replays; a capture
    that fails raises.  The program keeps the K5 tables its graph reads
    (:attr:`tables`).  On the CPU every step runs eagerly.
    :attr:`metrics` holds the last step's metrics as device tensors,
    valid until the next step.

    On a mesh (DTensor parameters) the batch buffers are DTensors placed
    once by ``batch_sharding``; :meth:`load` copies each rank's rows of
    the whole batch into its local shard, so no scatter runs inside the
    step.  A CUDA mesh must run on NCCL (:func:`_check_capturable`): any
    other group raises here, and no step falls back to eager."""

    def __init__(self, step_fn, params, opt_state, batch: dict):
        if not hasattr(step_fn, "in_place"):
            raise TypeError("TrainProgram: step_fn has no in_place form "
                            "(make_train_step gives one)")
        first = pytree.tree_leaves(params)[0]
        self.mesh = first.device_mesh if isinstance(first, DTensor) \
            else None
        self.device = first.to_local().device if self.mesh is not None \
            else first.device
        if self.mesh is not None and self.device.type == "cuda":
            _check_capturable(self.mesh)
        self.step_fn = step_fn
        self.params, self.opt_state = params, opt_state
        self.batch = {k: self._buffer(v) for k, v in batch.items()}
        self.metrics: dict | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.graph_metrics: dict | None = None    # the replay's outputs
        self.tables: list = []           # the K5 tables the graph reads
        self.capture_seconds: float | None = None
        self.replays = 0

    def _buffer(self, v):
        if self.mesh is None:
            return torch.empty_like(v)
        return place_local(torch.empty_like(v), self.mesh,
                           batch_sharding(self.mesh, v.dim()))

    def load(self, batch: dict) -> None:
        if batch.keys() != self.batch.keys() or any(
                v.shape != self.batch[k].shape or v.dtype != self.batch[k].dtype
                for k, v in batch.items()):
            raise ValueError("TrainProgram: a batch of another layout than "
                             "its buffers")
        for k, v in batch.items():
            if self.mesh is None:
                self.batch[k].copy_(v)
            else:
                rows = distribute_tensor(
                    v.to(self.device), self.mesh, self.batch[k].placements,
                    src_data_rank=None).to_local()
                self.batch[k].to_local().copy_(rows)

    def _step(self) -> dict:
        return self.step_fn.in_place(self.params, self.opt_state, self.batch)

    def _warm_up_and_capture(self) -> None:
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.metrics = self._step()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with K5.holding_tables() as tables, \
                torch.cuda.graph(graph, stream=stream):
            self.graph_metrics = self._step()
        torch.cuda.synchronize(self.device)
        self.graph, self.tables = graph, tables
        self.capture_seconds = time.perf_counter() - t0

    def step(self, batch: dict) -> dict:
        """One train step on ``batch`` (whole tensors, on a mesh the
        global batch on every rank); returns its metrics."""
        self.load(batch)
        if self.device.type != "cuda":
            self.metrics = self._step()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            self.replays += 1
            self.metrics = self.graph_metrics
        return self.metrics


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, data_iter, n_steps: int,
               checkpoint_dir: str | None = None,
               log_fn: Callable[[int, dict], None] | None = None,
               device=None, mesh=None):
    """Init (parameters from seed 0) or resume, step, checkpoint, log, on
    ``device`` (CUDA by default), placed on ``mesh`` when one is given
    (every rank draws the same parameters leaf by leaf and keeps its
    shards, and reads the same global batches).  The steps run through a
    :class:`TrainProgram`: one CUDA graph on the card, with or without a
    mesh; eager steps on the CPU.  They update the parameters and
    optimizer state in place; checkpoints snapshot them to the host
    before the next step."""
    from repro_torch.distributed.checkpoint import CheckpointManager

    if isinstance(data_iter, DeviceMesh):
        raise TypeError("train_loop takes the mesh as a keyword, mesh=...; "
                        "the JAX package's third positional argument is "
                        "data_iter here")
    device = resolve_device(device)
    step_fn = make_train_step(cfg, tcfg, mesh)
    first = batch_to_device(next(data_iter), device)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device, mesh=mesh)
    opt_state = adamw_init(params, tcfg.optimizer)
    start_step = 0
    ckpt = None
    if checkpoint_dir:
        ckpt = CheckpointManager(checkpoint_dir)
        restored = ckpt.restore_latest((params, opt_state))
        if restored is not None:
            (params, opt_state), start_step = restored

    batch = first
    history = []
    program = TrainProgram(step_fn, params, opt_state, first)
    for step in range(start_step, n_steps):
        t0 = time.time()
        metrics = program.step(batch)
        try:
            batch = batch_to_device(next(data_iter), device)
        except StopIteration:
            batch = first
        if log_fn and step % tcfg.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step_time"] = time.time() - t0
            log_fn(step, m)
            history.append((step, m))
        if ckpt and (step + 1) % tcfg.checkpoint_every == 0:
            ckpt.save((params, opt_state), step + 1)
    if ckpt:
        ckpt.save((params, opt_state), n_steps)
        ckpt.wait()
    return params, opt_state, history
