"""Base class for the port's DeepSpeed-shaped optimizers.

Port of ``deepspeed_tpu/ops/op_base.py``. Hyperparameters live in
``param_groups[0]``, where the LR schedulers write the learning rate. The
JAX base hands the engine a pure ``init``/``update`` transform to jit; here
:meth:`DeepSpeedOptimizer.init` builds the state for a list of fp32 master
tensors and :meth:`DeepSpeedOptimizer.update` updates masters and state in
place, on whatever device they live.
"""


class DeepSpeedOptimizer:
    """API-parity base: ``update(grads, state, params, lr)`` takes lists of
    fp32 tensors (grads and master params, one per leaf) and updates
    ``params`` and ``state`` in place."""

    def __init__(self, params=None, lr=1e-3, weight_decay=0.0, **defaults):
        self.defaults = dict(lr=lr, weight_decay=weight_decay, **defaults)
        self.param_groups = [dict(self.defaults, params=params)]
        self.state = {}

    @property
    def lr(self):
        return self.param_groups[0]["lr"]

    def init(self, params):
        raise NotImplementedError

    def update(self, grads, state, params, lr):
        raise NotImplementedError
