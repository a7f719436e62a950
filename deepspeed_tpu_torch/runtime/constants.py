"""Config keys and defaults.

Copy of ``deepspeed_tpu/runtime/constants.py`` (JAX-free): the same JSON
keys, so a ds_config that the JAX package reads loads unchanged here.
"""

#############################################
# Routes
#############################################
ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
ROUTE_ENCODE = "encode"

#############################################
# Batch size
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer and lr scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

#############################################
# Optimizer names
#############################################
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
MUADAM_OPTIMIZER = "muadam"
MUADAMW_OPTIMIZER = "muadamw"
MUSGD_OPTIMIZER = "musgd"
LION_OPTIMIZER = "lion"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
    ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER, LION_OPTIMIZER, SGD_OPTIMIZER, ADAGRAD_OPTIMIZER
]

# extra optimizer parameters for adam/adamw
TORCH_ADAM_PARAM = "torch_adam"
# default to adamw logic for adam/adamw optimizers unless user explicitly opts out
ADAM_W_MODE = "adam_w_mode"
ADAM_W_MODE_DEFAULT = True

#############################################
# fp16 / bf16 / fp32 precision
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_AUTO_CAST = "auto_cast"
FP16_AUTO_CAST_DEFAULT = False
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_CONSECUTIVE_HYSTERESIS = "consecutive_hysteresis"
FP16_CONSECUTIVE_HYSTERESIS_DEFAULT = False
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
FP16_MASTER_WEIGHTS_AND_GRADS = "fp16_master_weights_and_grads"
FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT = False

BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # keeping for backwards compatibility
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False
# BFLOAT16 optimizer immediate gradient update
BFLOAT16_IMMEDIATE_GRAD_UPDATE = "immediate_grad_update"
BFLOAT16_IMMEDIATE_GRAD_UPDATE_DEFAULT = True

AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

PREDIVIDE_FACTOR = "predivide_factor"
PREDIVIDE_FACTOR_DEFAULT = 1.0

#############################################
# Communication
#############################################
COMMUNICATION_DATA_TYPE = "communication_data_type"
COMMUNICATION_DATA_TYPE_DEFAULT = None
SEQ_PARALLEL_COMMUNICATION_DATA_TYPE = "seq_parallel_communication_data_type"
SEQ_PARALLEL_COMMUNICATION_DATA_TYPE_DEFAULT = "fp32"
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

#############################################
# Steps / logging
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

#############################################
# Misc training toggles
#############################################
DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False

USE_MULTI_RANK_BUCKET_ALLREDUCE = "use_multi_rank_bucket_allreduce"
USE_MULTI_RANK_BUCKET_ALLREDUCE_DEFAULT = True

ALLREDUCE_ALWAYS_FP32 = "allreduce_always_fp32"
ALLREDUCE_ALWAYS_FP32_DEFAULT = False

SCALE_TOLERANCE = "scale_tolerance"
SCALE_TOLERANCE_DEFAULT = 0.01

GRADIENT_NOISE_SCALE = "gradient_noise_scale"

SPARSE_ATTENTION = "sparse_attention"

ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False
ZERO_FORCE_DS_CPU_OPTIMIZER = "zero_force_ds_cpu_optimizer"
ZERO_FORCE_DS_CPU_OPTIMIZER_DEFAULT = True

CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
LOAD_UNIVERSAL_CHECKPOINT_DEFAULT = False
USE_NODE_LOCAL_STORAGE_CHECKPOINT = "use_node_local_storage"
USE_NODE_LOCAL_STORAGE_CHECKPOINT_DEFAULT = False

DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"
GRAD_ACCUM_DTYPE_DEFAULT = None

#############################################
# Curriculum learning (legacy) / data efficiency
#############################################
CURRICULUM_LEARNING = "curriculum_learning"
CURRICULUM_ENABLED = "enabled"
CURRICULUM_ENABLED_DEFAULT = False

#############################################
# Mesh / parallel topology (TPU-native extension).
# The reference gets its model-parallel topology from an external mpu
# object; on TPU the engine owns the jax.sharding.Mesh, configured here.
#############################################
MESH = "mesh"
MESH_DATA = "data_parallel_size"
MESH_TENSOR = "tensor_parallel_size"
MESH_PIPE = "pipeline_parallel_size"
MESH_SEQUENCE = "sequence_parallel_size"
MESH_EXPERT = "expert_parallel_size"

PIPELINE = "pipeline"
PIPELINE_STAGES = "stages"
PIPELINE_STAGES_DEFAULT = "auto"
PIPELINE_PARTITION = "partition"
PIPELINE_PARTITION_DEFAULT = "best"
PIPELINE_SEED_LAYERS = "seed_layers"
PIPELINE_SEED_LAYERS_DEFAULT = False
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL = "activation_checkpoint_interval"
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT = 0

#############################################
# Validation modes
#############################################


class ValidationMode:
    WARN = "WARN"
    IGNORE = "IGNORE"
    FAIL = "FAIL"
