"""Wall-clock and throughput timers.

Port of ``deepspeed_tpu/utils/timer.py`` (``SynchronizedWallClockTimer``,
``ThroughputTimer``, ``NoopTimer``). Synchronization is
``torch.cuda.synchronize()`` once CUDA is in use, so a timer reads the end
of the device work it brackets; on the CPU it is a no-op.
"""

import time

import torch

from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
BACKWARD_INNER_MICRO_TIMER = "bwd_inner_microstep"
BACKWARD_INNER_GLOBAL_TIMER = "bwd_inner"
BACKWARD_REDUCE_MICRO_TIMER = "bwd_allreduce_microstep"
BACKWARD_REDUCE_GLOBAL_TIMER = "bwd_allreduce"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


def _sync():
    """Block until all dispatched device work completes."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """A single named timer with start/stop/elapsed accumulation."""

    def __init__(self, name, synchronize=True):
        self.name_ = name
        self.started_ = False
        self.start_time = 0.0
        self.elapsed_ = 0.0
        self.records = []
        self.synchronize = synchronize

    def start(self):
        assert not self.started_, f"{self.name_} timer has already been started"
        if self.synchronize:
            _sync()
        self.start_time = time.time()
        self.started_ = True

    def stop(self, reset=False, record=False):
        assert self.started_, f"{self.name_} timer is not started"
        if self.synchronize:
            _sync()
        elapsed = time.time() - self.start_time
        if reset:
            self.elapsed_ = elapsed
        else:
            self.elapsed_ += elapsed
        if record:
            self.records.append(self.elapsed_)
        self.started_ = False

    def reset(self):
        self.started_ = False
        self.elapsed_ = 0.0
        self.records = []

    def elapsed(self, reset=True):
        started = self.started_
        if started:
            self.stop()
        elapsed = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return elapsed

    def mean(self):
        if not self.records:
            return 0.0
        return sum(self.records) / len(self.records)


class SynchronizedWallClockTimer:
    """Group of named timers; mirrors the reference timer surface."""

    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def has_timer(self, name):
        return name in self.timers

    @staticmethod
    def memory_usage():
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return "mem stats unavailable"
        alloc = torch.cuda.memory_allocated() / (1024**3)
        max_alloc = torch.cuda.max_memory_allocated() / (1024**3)
        return f"mem_alloc={alloc:.4f}GB max_alloc={max_alloc:.4f}GB"

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=None, ranks=None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        log_dist(string, ranks=ranks or [0])

    def get_mean(self, names, normalizer=1.0, reset=True):
        assert normalizer > 0.0
        means = {}
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].mean() * 1000.0 / normalizer
                means[name] = elapsed_time
                if reset:
                    self.timers[name].reset()
        return means


class NoopTimer:

    class Timer:

        def start(self):
            ...

        def reset(self):
            ...

        def stop(self, **kwargs):
            ...

        def elapsed(self, **kwargs):
            return 0

        def mean(self):
            return 0

    def __init__(self):
        self.timer = self.Timer()

    def __call__(self, name):
        return self.timer

    def has_timer(self, name):
        return True

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=None, ranks=None):
        ...

    def get_mean(self, names, normalizer=1.0, reset=True):
        ...


class ThroughputTimer:
    """Samples/sec tracking across steps (reference timer.py:199)."""

    def __init__(self, config, batch_size, start_step=2, steps_per_output=None, monitor_memory=False, logging_fn=None):
        self.config = config
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = batch_size or 1
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn
        if self.logging is None:
            from deepspeed_tpu_torch.utils.logging import logger
            self.logging = logger.info
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.global_step_count >= self.start_step:
            _sync()
            self.start_time = time.time()

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            _sync()
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step:
                if report_speed and self.steps_per_output and self.global_step_count % self.steps_per_output == 0:
                    self.logging(f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                                 f"global_step={self.global_step_count}, RunningAvgSamplesPerSec="
                                 f"{self.avg_samples_per_sec():.6f}, CurrSamplesPerSec="
                                 f"{self.batch_size / self.step_elapsed_time:.6f}")
                self.step_elapsed_time = 0

    def avg_samples_per_sec(self):
        if self.global_step_count > 0:
            total_step_offset = self.global_step_count - self.start_step
            if total_step_offset <= 0 or self.total_elapsed_time == 0:
                return 0.0
            avg_time_per_step = self.total_elapsed_time / total_step_offset
            return self.batch_size / avg_time_per_step
        return 0.0


def trim_mean(data, trim_percent):
    """Compute the trimmed mean of a list of numbers."""
    assert 0.0 <= trim_percent <= 1.0
    n = len(data)
    data.sort()
    k = int(round(n * trim_percent))
    return sum(data[k:n - k]) / max(1, n - 2 * k)
