"""Model families of the port: counterparts of `llmlb_tpu/models`.

`family_for(cfg)` resolves the module of a config's family (init_params,
param_shapes, init_kv_pages / init_kv_cache and the serving entry points:
one contract), so the engine's loop is the same for the dense Llama class
(llama.py) and the sparse-MoE Mixtral class (mixtral.py). Each family
module also owns its facts (LORA_TARGETS, HF_FFN_NAMES, hf_config_fields,
PREFILL_COUPLES_ROWS, and `encode` where it serves embeddings); this module
alone decides which family a config or a HF `config.json` belongs to."""


def family_for(cfg):
    """The serving module of a model config's family."""
    from llmlb_tpu_torch.models import llama, mixtral

    if isinstance(cfg, mixtral.MixtralConfig):
        return mixtral
    if isinstance(cfg, llama.LlamaConfig):
        return llama
    raise TypeError(f"no model family for config type {type(cfg).__name__}")


def config_from_hf(hf: dict, **kwargs):
    """The config of a HF `config.json` dict, in its family's class: a
    MixtralConfig for a Mixtral checkpoint, as the reference reads it,
    else a LlamaConfig. `kwargs` go to from_hf_config (its dtype)."""
    from llmlb_tpu_torch.models import llama, mixtral

    if hf.get("model_type") == "mixtral" or hf.get("num_local_experts",
                                                   0) > 1:
        return mixtral.MixtralConfig.from_hf_config(hf, **kwargs)
    return llama.LlamaConfig.from_hf_config(hf, **kwargs)
