"""PyTorch and CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX one, which stays the reference. It
imports torch and numpy, never jax or anything of ``deepspeed_tpu``.
Importing it loads nothing heavy: :func:`initialize` imports the training
engine when called, and ``deepspeed_tpu_torch.inference.v2`` holds ragged
serving. Entry points run on the GPU unless the caller passes
``device="cpu"``; on the CPU every kernel is replaced by its plain PyTorch
version."""

__version__ = "0.1.0"


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               collate_fn=None,
               config=None,
               config_params=None,
               device=None):
    """Build the training engine (``deepspeed_tpu.initialize``'s surface,
    on one device).

    Arguments:
        model: an ``nn.Module`` whose forward returns the loss or a tuple
            whose first element is the loss (``models.build_llama``).
        config: a ds_config dict, a path to its JSON, or base64 JSON
            (``config_params``, or ``args.deepspeed_config``, when None).
        device: None means CUDA, and raises without a GPU; "cpu" runs the
            plain versions of the kernels.

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    Hybrid-engine and pipeline configs raise ``NotImplementedError`` naming
    their ROADMAP.md item, from the config."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a model")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None) or getattr(
            args, "deepspeed_config_dict", None)
    if config is None:
        raise ValueError("DeepSpeed requires --deepspeed_config to specify configuration file")
    engine = DeepSpeedEngine(model=model, config=DeepSpeedConfig(config), optimizer=optimizer,
                             model_parameters=model_parameters, training_data=training_data,
                             lr_scheduler=lr_scheduler, collate_fn=collate_fn, device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
