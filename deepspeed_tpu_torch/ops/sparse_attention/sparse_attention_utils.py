"""Sparse-attention integration utilities and ds_config parsing.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``:
the ds_config names a sparsity mode (dense/fixed/variable/bigbird/
bslongformer) and its knobs; :func:`get_sparse_attention_config` builds
the matching ``SparsityConfig`` by the same section-recognition rules, and
:class:`SparseAttentionUtils` pads and unpads sequences to the block
granularity, extends position tables for long-sequence fine-tuning and
swaps a BERT model onto block-sparse attention. The port's models own
their weights, so the swap carries them over to the new model (the
position table extended by :meth:`SparseAttentionUtils.extend_position_embedding`
when ``max_position`` grows it), where the JAX package returns a module
definition for the caller's params.
"""

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import SparseSelfAttention
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (BigBirdSparsityConfig,
                                                                      BSLongformerSparsityConfig,
                                                                      DenseSparsityConfig,
                                                                      FixedSparsityConfig,
                                                                      VariableSparsityConfig)

MODES = {"dense": DenseSparsityConfig, "fixed": FixedSparsityConfig,
         "variable": VariableSparsityConfig, "bigbird": BigBirdSparsityConfig,
         "bslongformer": BSLongformerSparsityConfig}

# every knob any SparsityConfig constructor accepts: recognizes a bare
# section dict passed without the "sparse_attention" wrapper
_SECTION_KEYS = {"mode", "block", "different_layout_per_head", "num_local_blocks",
                 "num_global_blocks", "attention", "horizontal_global_attention",
                 "num_different_global_patterns", "num_random_blocks",
                 "num_sliding_window_blocks", "seed", "global_block_indices",
                 "global_block_end_indices"}
# knobs only a sparse-attention section would carry: a bare dict needs at
# least one of these (generic keys like 'seed'/'block' alone must not
# enable sparse attention)
_UNAMBIGUOUS_KEYS = _SECTION_KEYS - {"mode", "block", "seed", "attention"}


def get_sparse_attention_config(ds_config, num_heads):
    """``ds_config``: a full ds_config dict (with a ``sparse_attention``
    section) or the section itself → a ``SparsityConfig`` instance, or
    None when absent."""
    if not isinstance(ds_config, dict):
        return None
    if "sparse_attention" in ds_config:
        # an enabled-but-empty section means fixed-mode defaults
        section = dict(ds_config["sparse_attention"] or {})
    elif "mode" in ds_config:
        section = dict(ds_config)  # the section itself; a bad knob raises below
    elif (ds_config and set(ds_config) <= _SECTION_KEYS
          and set(ds_config) & _UNAMBIGUOUS_KEYS):
        section = dict(ds_config)  # mode-less bare section → fixed-mode defaults
    else:
        return None  # {'seed': 1} or {'block': 8} alone is not a sparsity request
    mode = section.pop("mode", "fixed")
    if mode not in MODES:
        raise NotImplementedError(f"sparsity mode {mode!r}: known modes {sorted(MODES)}")
    return MODES[mode](num_heads=num_heads, **section)


def build_sparse_self_attention(ds_config, num_heads, max_seq_length=2048):
    """ds_config → a ready ``SparseSelfAttention`` (or None)."""
    cfg = get_sparse_attention_config(ds_config, num_heads)
    return None if cfg is None else SparseSelfAttention(cfg, max_seq_length=max_seq_length)


def freeze_section(section):
    """ds_config section dict → hashable ``((key, value), ...)`` form
    (lists become tuples) for storage on frozen model configs."""
    return tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v) for k, v in dict(section).items()))


def thaw_section(frozen):
    """Inverse of :func:`freeze_section`."""
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in frozen}


def _tile_rows(table, rows):
    if isinstance(table, torch.Tensor):
        return table.repeat(-(-rows // table.shape[0]), 1)[:rows]
    return np.tile(np.asarray(table), (-(-rows // table.shape[0]), 1))[:rows]


class SparseAttentionUtils:
    """The reference-named helpers, over the port's modules and tensors."""

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            model, max_position=None, sparsity_config=None, ds_config=None):
        """→ a new model of the same class whose encoder blocks run
        layout-sparse attention, carrying ``model``'s weights (the position
        table tiled up to ``max_position`` when that grows it). Pass either
        a ``SparsityConfig``-style section dict / ``ds_config`` or a
        constructed ``sparsity_config`` (its constructor kwargs are
        recovered from the instance). Only the bidirectional BERT family is
        supported, as in the reference."""
        import dataclasses

        from deepspeed_tpu_torch.models.bert import BertConfig
        cfg = getattr(model, "config", None)
        if not isinstance(cfg, BertConfig):
            raise NotImplementedError(
                f"sparse self-attention replacement supports the BERT family "
                f"(bidirectional); got {type(model).__name__} — the reference "
                f"util is equally BERT-only (sparse_attention_utils.py:86)")
        if ds_config is not None:
            # validate (raises on unknown mode/knobs), then keep the RAW
            # section: instances don't round-trip (BigBird's rng state)
            if get_sparse_attention_config(ds_config, cfg.num_attention_heads) is None:
                raise ValueError("ds_config carries no sparse_attention section")
            section = dict(ds_config.get("sparse_attention", ds_config) or {})
            section.setdefault("mode", "fixed")
        elif sparsity_config is not None:
            mode = next((m for m, c in MODES.items() if type(sparsity_config) is c), None)
            if mode is None:
                raise ValueError(
                    f"unrecognized sparsity config {type(sparsity_config).__name__}; "
                    f"pass an instance of one of {sorted(c.__name__ for c in MODES.values())} "
                    f"or the ds_config section form")
            section = {"mode": mode,
                       **{k: v for k, v in vars(sparsity_config).items()
                          if k != "num_heads" and not k.startswith("_")}}
        else:
            raise ValueError("pass sparsity_config or ds_config")
        new_cfg = dataclasses.replace(
            cfg, sparse_attention=freeze_section(section),
            **({"max_position_embeddings": int(max_position)} if max_position else {}))
        state = model.state_dict()
        rows = new_cfg.max_position_embeddings + new_cfg.position_offset
        if rows != state["model.embed_positions"].shape[0]:
            state = SparseAttentionUtils.extend_position_embedding(state, rows)
        p0 = next(model.parameters())
        new = type(model)(new_cfg, device=p0.device, dtype=p0.dtype,
                          **({"num_labels": model.num_labels}
                             if hasattr(model, "num_labels") else {}))
        new.load_state_dict(state)
        return new

    @staticmethod
    def extend_position_embedding(params, max_position, table_key="embed_positions"):
        """Tile a learned position table up to ``max_position`` rows (BERT/
        RoBERTa long-sequence fine-tuning init). ``params``: a state dict
        (``{"model.embed_positions": tensor, ...}``) or a nested dict of
        tensors or arrays; every 2-D leaf named ``table_key`` is extended
        and the rest kept. Raises when none exists or the request would
        truncate learned positions."""
        found = []

        def walk(node):
            out = {}
            for key, v in node.items():
                if isinstance(v, dict):
                    out[key] = walk(v)
                elif str(key).split(".")[-1] == table_key and getattr(v, "ndim", 0) == 2:
                    if max_position <= v.shape[0]:  # never destroy learned rows
                        raise ValueError(
                            f"extend_position_embedding: max_position {max_position} "
                            f"must exceed the current table ({v.shape[0]} rows)")
                    found.append(key)
                    out[key] = _tile_rows(v, max_position)
                else:
                    out[key] = v
            return out

        out = walk(params)
        if not found:
            raise ValueError(f"no 2-D {table_key!r} table found in the params")
        return out

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        tokenizer.model_max_length = max_position
        return tokenizer

    @staticmethod
    def pad_to_block_size(block_size, input_ids, attention_mask=None,
                          token_type_ids=None, position_ids=None, inputs_embeds=None,
                          pad_token_id=0):
        """Right-pad the sequence dim to a multiple of ``block_size`` →
        (pad_len, padded tensors...). The returned attention_mask zeroes
        the padding, so a padded batch takes the masked-dense path."""
        as_t = lambda x: None if x is None else torch.as_tensor(x)
        input_ids, attention_mask, token_type_ids, position_ids, inputs_embeds = map(
            as_t, (input_ids, attention_mask, token_type_ids, position_ids, inputs_embeds))
        ref = input_ids if input_ids is not None else inputs_embeds
        pad_len = (-ref.shape[1]) % block_size

        def pad(x, value=0):
            if x is None or pad_len == 0:
                return x
            return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad_len), value=value)

        if attention_mask is None and pad_len:
            attention_mask = torch.ones(ref.shape[:2], dtype=torch.int32, device=ref.device)
        return (pad_len, pad(input_ids, pad_token_id), pad(attention_mask, 0),
                pad(token_type_ids, 0), pad(position_ids, 0), pad(inputs_embeds, 0))

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Drop the padding rows again."""
        if pad_len == 0:
            return sequence_output
        return sequence_output[:, :-pad_len]
