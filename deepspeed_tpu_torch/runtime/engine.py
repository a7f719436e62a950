"""The DeepSpeed training engine on one CUDA device (or the CPU).

Port of the single-device core of ``deepspeed_tpu/runtime/engine.py``:
construction, ``forward``/``backward``/``step``, the update math and
``train_batch``, with the same counters (``global_steps``,
``global_samples``, ``micro_steps``, ``global_grad_norm``).

State, as the JAX engine's ``_materialize_state`` makes it:
- the model's float parameters are cast to the compute dtype (bf16 when
  the config enables it, else fp32) in place;
- the fp32 master copy is made from those **bf16-rounded** parameters
  (in fp32 the master is the parameters themselves);
- the optimizer's moments are fp32, beside the master.

One micro-batch: ``forward`` runs the model and returns its loss (the
output's first element); ``backward`` takes gradients of ``loss / gas``
(the loss scale is 1: bf16 and fp32 train unscaled, fp16 is not ported)
with respect to the compute-dtype parameters and
adds them, cast to ``data_types.grad_accum_dtype`` (fp32 by default), to
the accumulator. At the accumulation boundary ``step`` takes the global
norm, clips by ``min(1, clip / (norm + 1e-6))``, runs the optimizer
on the master with the LR read from ``get_lr()`` before the update, recasts
the parameters from the master, and then steps the LR scheduler.
``train_batch`` runs that loop over ``gas`` micro-batches and returns the
mean micro-batch loss.

ZeRO: ``zero_optimization.stage`` 0-3 is accepted. On one device every
stage computes the same thing, as the JAX engine on a 1-device mesh shards
nothing; sharding over processes (``torch.distributed``/NCCL) is ROADMAP.md
port queue item 7. Checkpointing (item 8), fp16 loss scaling (item 9),
offload (item 12) and the optimizers other than Adam/AdamW (item 11)
raise ``NotImplementedError``.

The parameters are updated in place (``copy_`` from the master), where
the JAX engine returns new buffers.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.op_base import DeepSpeedOptimizer
from deepspeed_tpu_torch.roadmap import not_ported
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.constants import (ADAM_OPTIMIZER, ADAMW_OPTIMIZER,
                                                   DEEPSPEED_OPTIMIZERS, FUSED_ADAM_OPTIMIZER)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER, NoopTimer,
                                             SynchronizedWallClockTimer, ThroughputTimer)

_ACCUM_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16,
                 "bf16": torch.bfloat16}


class DeepSpeedEngine:
    """Wraps a model (an ``nn.Module`` whose forward returns the loss or a
    tuple whose first element is the loss) to expose forward / backward /
    step and ``train_batch``."""

    def __init__(self, model, config, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, collate_fn=None, device=None):
        self._config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        self.device = resolve_device(device)
        self.module = model
        self.client_optimizer = optimizer
        self.collate_fn = collate_fn
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.global_grad_norm = 0.0
        self.losses = None
        self._is_training = True

        self.compute_dtype = torch.bfloat16 if self._config.bfloat16_enabled else torch.float32
        self._grad_accum_dtype = _ACCUM_DTYPES[self._config.grad_accum_dtype]
        self.zero_stage = self._config.zero_config.stage
        self.optimizer = self._configure_optimizer()
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)

        self.wall_clock_breakdown_enabled = self._config.wall_clock_breakdown
        self.timers = (SynchronizedWallClockTimer() if self.wall_clock_breakdown_enabled
                       else NoopTimer())
        self.tput_timer = ThroughputTimer(config=self._config.timers_config,
                                          batch_size=self.train_batch_size(),
                                          steps_per_output=self.steps_per_print())
        self.training_dataloader = (self.deepspeed_io(training_data)
                                    if training_data is not None else None)
        self._materialize_state(model_parameters)
        log_dist(f"DeepSpeedEngine (torch): device={self.device} zero_stage={self.zero_stage} "
                 f"dtype={self.compute_dtype} micro_batch={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()} "
                 f"train_batch={self.train_batch_size()}", ranks=[0])

    # ------------------------------------------------------------------
    # Config accessors (the JAX engine's surface)
    # ------------------------------------------------------------------
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def steps_per_print(self):
        return self._config.steps_per_print

    def bfloat16_enabled(self):
        return self._config.bfloat16_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def train(self, mode=True):
        self._is_training = mode

    def eval(self):
        self._is_training = False

    def get_lr(self):
        return [g["lr"] for g in self.optimizer.param_groups]

    def get_global_grad_norm(self):
        return self.global_grad_norm

    # ------------------------------------------------------------------
    # Optimizer / scheduler
    # ------------------------------------------------------------------
    def _configure_optimizer(self):
        if self.client_optimizer is not None:
            if not isinstance(self.client_optimizer, DeepSpeedOptimizer):
                raise not_ported(f"client optimizer {type(self.client_optimizer).__name__} "
                                 f"(the port's optimizers are ops/adam/fused_adam.py)", 11)
            return self.client_optimizer
        name = self._config.optimizer_name
        params = dict(self._config.optimizer_params or {})
        params.pop("torch_adam", None)
        adam_w_mode = params.pop("adam_w_mode", True)
        if name is None:
            return FusedAdam()
        name = name.lower()
        if name in (ADAM_OPTIMIZER, FUSED_ADAM_OPTIMIZER):
            return FusedAdam(adam_w_mode=adam_w_mode, **params)
        if name == ADAMW_OPTIMIZER:
            return FusedAdam(adam_w_mode=True, **params)
        if name in DEEPSPEED_OPTIMIZERS or name in ("muadam", "muadamw", "musgd"):
            raise not_ported(f"optimizer {name!r}", 11)
        raise ValueError(f"Unknown optimizer {name}")

    def _configure_lr_scheduler(self, client_lr_scheduler):
        if client_lr_scheduler is not None:
            if callable(client_lr_scheduler):
                return client_lr_scheduler(self.optimizer)
            return client_lr_scheduler
        if self._config.scheduler_name is not None:
            sched_cls = getattr(lr_schedules, self._config.scheduler_name, None)
            if sched_cls is None:
                raise ValueError(f"Unknown lr schedule {self._config.scheduler_name}")
            return sched_cls(self.optimizer, **(self._config.scheduler_params or {}))
        return None

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _materialize_state(self, model_parameters):
        self.module.to(self.device)
        for p in self.module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(self.compute_dtype)
        if model_parameters is None:
            self.params = [p for p in self.module.parameters() if p.requires_grad]
        else:
            self.params = list(model_parameters)
            own = {id(p) for p in self.module.parameters()}
            if not all(id(p) in own for p in self.params):
                raise ValueError("model_parameters must be parameters of the model")
        if self.compute_dtype == torch.float32:
            self.master_params = [p.data for p in self.params]
        else:
            # from the compute-dtype-rounded values, as the JAX engine does
            self.master_params = [p.detach().float() for p in self.params]
        self.opt_state = self.optimizer.init(self.master_params)
        self._grads_acc = None

    def destroy(self):
        """Drop the fp32 master, the optimizer state and the gradient
        accumulator, so the memory can be reclaimed."""
        self.master_params = None
        self.opt_state = None
        self._grads_acc = None

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(self.device)
        return x

    # ------------------------------------------------------------------
    # forward / backward / step
    # ------------------------------------------------------------------
    def forward(self, *args, **kwargs):
        """Run the model on one micro-batch. Training: returns the loss
        (the output's first element) with its graph, for :meth:`backward`;
        eval: the model's output, without a graph."""
        args = [self._to_device(a) for a in args]
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        if not self._is_training:
            with torch.no_grad():
                return self.module(*args, **kwargs)
        self.timers(FORWARD_GLOBAL_TIMER).start()
        out = self.module(*args, **kwargs)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss):
        """Gradients of ``loss / gas`` w.r.t. the compute-dtype parameters,
        added to the accumulator in ``grad_accum_dtype``."""
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        scaled = loss.float() / self.gradient_accumulation_steps()
        grads = torch.autograd.grad(scaled, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        if self._grads_acc is None:
            self._grads_acc = [g.to(self._grad_accum_dtype) for g in grads]
        else:
            # leaf by leaf, in place: a list of widened copies would hold a
            # second fp32 copy of every gradient (12.7 GB at 3.17 B params)
            for acc, g in zip(self._grads_acc, grads):
                acc.add_(g.to(acc.dtype))
        self.micro_steps += 1
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps % self.gradient_accumulation_steps()) == 0

    def zero_grad(self):
        self._grads_acc = None

    @torch.no_grad()
    def _update_math(self, lr):
        """Global norm, clip, optimizer on the master, recast the
        parameters → the global grad norm (a 0-dim fp32 tensor)."""
        grads32 = [g.float() for g in self._grads_acc]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads32)))
        clip = float(self.gradient_clipping() or 0.0)
        if clip > 0.0:
            torch._foreach_mul_(grads32, torch.clamp(clip / (gnorm + 1e-6), max=1.0))
        self.optimizer.update(grads32, self.opt_state, self.master_params, lr)
        if self.compute_dtype != torch.float32:
            torch._foreach_copy_([p.data for p in self.params], self.master_params)
        return gnorm

    def step(self, lr_kwargs=None):
        """Optimizer step at gradient-accumulation boundaries."""
        if self._grads_acc is None:
            raise RuntimeError("step() called with no accumulated gradients")
        if not self.is_gradient_accumulation_boundary():
            return
        self.timers(STEP_GLOBAL_TIMER).start()
        gnorm = self._update_math(self.get_lr()[0])
        self.global_grad_norm = float(gnorm)
        self._grads_acc = None
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step(**(lr_kwargs or {}))
        self.timers(STEP_GLOBAL_TIMER).stop()
        if self.wall_clock_breakdown_enabled and self.global_steps % self.steps_per_print() == 0:
            self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER])

    # ------------------------------------------------------------------
    # train_batch
    # ------------------------------------------------------------------
    def _split_batch(self, data_iter, batch):
        """→ ``gas`` micro-batches, each ``(args, kwargs)``."""
        gas = self.gradient_accumulation_steps()
        if batch is None:
            if data_iter is None:
                raise ValueError("provide data_iter or batch")
            micro = [next(data_iter) for _ in range(gas)]
        else:
            if not (isinstance(batch, tuple) and len(batch) == 2 and isinstance(batch[1], dict)):
                batch = ((batch,) if not isinstance(batch, (tuple, list)) else tuple(batch), {})
            args, kwargs = batch
            lead = (list(args) + list(kwargs.values()))[0].shape[0]
            mbs = self.train_micro_batch_size_per_gpu()
            if lead not in (gas, gas * mbs):
                raise ValueError(f"batch leading dim {lead} is neither gas={gas} nor "
                                 f"gas*micro={gas * mbs}")

            def part(x, g):
                return x[g] if lead == gas else x[g * mbs:(g + 1) * mbs]

            micro = [(tuple(part(a, g) for a in args), {k: part(v, g) for k, v in kwargs.items()})
                     for g in range(gas)]
        out = []
        for m in micro:
            if not (isinstance(m, tuple) and len(m) == 2 and isinstance(m[1], dict)):
                m = ((m,) if not isinstance(m, (tuple, list)) else tuple(m), {})
            out.append(m)
        return out

    def train_batch(self, data_iter=None, batch=None):
        """One full training step: ``gas`` micro-batch forward/backward
        passes, then the update. ``batch`` has a leading ``gas`` or
        ``gas * micro`` dim; ``data_iter`` yields one micro-batch per call.
        → the mean micro-batch loss (0-dim fp32 tensor)."""
        micro = self._split_batch(data_iter, batch)
        self.tput_timer.start()
        self.timers(TRAIN_BATCH_TIMER).start()
        losses = []
        for args, kwargs in micro:
            loss = self.forward(*args, **kwargs)
            self.backward(loss)
            losses.append(loss.detach().float())
        self.step()
        mean_loss = torch.stack(losses).mean()
        self.losses = mean_loss
        self.timers(TRAIN_BATCH_TIMER).stop()
        self.tput_timer.stop(global_step=True)
        return mean_loss

    # ------------------------------------------------------------------
    # Data loading, and what is not ported
    # ------------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size=None, data_sampler=None, collate_fn=None):
        return DeepSpeedDataLoader(dataset=dataset,
                                   batch_size=batch_size or self.train_micro_batch_size_per_gpu(),
                                   collate_fn=collate_fn or self.collate_fn,
                                   data_parallel_world_size=1,
                                   data_parallel_rank=0,
                                   data_sampler=data_sampler)

    def save_checkpoint(self, *args, **kwargs):
        raise not_ported("save_checkpoint", 8)

    def load_checkpoint(self, *args, **kwargs):
        raise not_ported("load_checkpoint", 8)
