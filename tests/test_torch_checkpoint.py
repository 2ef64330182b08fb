"""The port's HF checkpoint loader, HFTokenizer and `--checkpoint`, against
the JAX package.

Fixtures are written here: debug-tiny's JAX weights
(`llama.init_params(cfg, PRNGKey(0))`, in f32 and in bf16) through the
port's `hf_tensors` and `save_sharded` (contiguous bytes, three shards and
a `model.safetensors.index.json`), a `config.json` from `hf_config`, and a
byte-level BPE tokenizer trained here with `tokenizers` and saved beside
them with a chat template.

- `load_checkpoint` equals `params_from_numpy` of the JAX params and the
  JAX package's `load_checkpoint` of the same directory, bit for bit; with
  `quantize_weights=True` it equals the port's and the JAX package's
  `quantize_params` of the same weights, bit for bit. This is the
  reference test's contract (tests/engine/test_quantized_serving.py,
  "the same int8 layout EngineCore's own pass produces from the same
  checkpoint"); that test fails on the reference because its fixture
  hands strided views to a writer that ignores strides, not because of
  its loader.
- `load_config` agrees with the JAX package's field for field on the
  published `config.json` values of Llama-3-8B, Llama-3.1-8B (llama3 rope
  scaling) and Qwen2.5-0.5B (qkv bias, tied embeddings), each equal to the
  port's preset; Mixtral-8x7B's loads as the reference's MixtralConfig,
  and an unsupported rope scaling is refused as the reference refuses it.
- A tiny Mixtral checkpoint loads as the reference's weights, in bf16 and
  int8.
- `HFTokenizer` encodes, decodes and renders the chat template as the
  reference's does.
- `main(["--checkpoint", dir, "--device", "cpu", ...])` serves a chat
  whose greedy ids are the JAX `Engine.from_checkpoint`'s on the same
  directory (the one JAX engine of this file). Both packages serve a
  checkpoint in bf16 (neither reads a dtype from config.json); there the
  two implementations' logits differ by bf16 rounding (~0.03 on logits
  near 2.5) and debug-tiny's random weights leave near ties (top logits
  0.007 apart) that such rounding flips, so this comparison has both
  `load_config`s give fp32, where the port is held to the reference's
  greedy ids everywhere else.
"""

import dataclasses
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.engine import weights as jax_weights
from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.engine.service import Engine as JaxEngine
from llmlb_tpu.engine.tokenizer import HFTokenizer as JaxHFTokenizer
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.quant import quantize_params as jax_quantize_params
from llmlb_tpu_torch.engine import server as server_mod
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.safetensors_io import (
    INDEX_NAME,
    SafetensorsFile,
    save_sharded,
)
from llmlb_tpu_torch.engine.tokenizer import HFTokenizer
from llmlb_tpu_torch.engine.weights import (
    hf_config,
    hf_tensors,
    load_checkpoint,
    load_config,
    params_from_numpy,
)
from llmlb_tpu_torch.quant import quantize_params

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
MESSAGES = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Name a colour."}]
CHAT_TEMPLATE = ("{% for m in messages %}<|{{ m['role'] }}|>{{ m['content'] }}"
                 "\n{% endfor %}{% if add_generation_prompt %}<|assistant|>"
                 "{% endif %}")
CORPUS = ["the quick brown fox jumps over the lazy dog",
          "a colour is a colour, said the painter to the dog",
          "name three colours: red, green and blue"] * 20


def _cfgs(name: str):
    tdt, jdt = DTYPES[name]
    return (dataclasses.replace(get_preset("debug-tiny"), dtype=tdt),
            dataclasses.replace(jax_preset("debug-tiny"), dtype=jdt))


def _save_tokenizer(path: str) -> None:
    """A byte-level BPE of 300 ids trained on CORPUS, with BOS/EOS and a
    chat template, saved as HF tokenizer files."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    from tokenizers.processors import TemplateProcessing

    tok.post_processor = TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", tok.token_to_id("<s>"))])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                                   eos_token="</s>")
    fast.chat_template = CHAT_TEMPLATE
    fast.save_pretrained(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{dtype name: (dir, JAX params as numpy)}; the bf16 directory also
    holds the tokenizer."""
    out = {}
    for name in DTYPES:
        cfg, jcfg = _cfgs(name)
        jparams = {k: np.asarray(v) for k, v in jllama.init_params(
            jcfg, jax.random.PRNGKey(0)).items()}
        path = str(tmp_path_factory.mktemp(f"ckpt-{name}"))
        files = save_sharded(hf_tensors(jparams, cfg), path, shards=3)
        with open(f"{path}/config.json", "w") as f:
            json.dump(hf_config(cfg), f)
        if name == "bf16":
            _save_tokenizer(path)
        out[name] = (path, jparams, files)
    return out


def _bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a numpy/JAX array (bfloat16 as
    int16), for a bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_shards_and_index_are_written_and_read_back(checkpoints, name):
    path, jparams, files = checkpoints[name]
    with open(f"{path}/{INDEX_NAME}") as f:
        index = json.load(f)
    assert sorted(set(index["weight_map"].values())) == files
    cfg, _ = _cfgs(name)
    want = hf_tensors(jparams, cfg)
    assert sorted(index["weight_map"]) == sorted(want)
    for fname in files:
        shard = SafetensorsFile(f"{path}/{fname}")
        for key in shard.keys():
            got = shard.get_torch(key)
            assert got.dtype == cfg.dtype  # never widened on the host
            assert np.array_equal(_bits(got),
                                  _bits(np.ascontiguousarray(want[key])))
    # the streaming load is the JAX package's whole-leaf conversion
    _assert_same(load_checkpoint(path, cfg, device="cpu"),
                 jax_weights.convert_hf_tensors(
                     _cfgs(name)[1], jax_weights._safetensors_getter(path)))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_load_checkpoint_is_the_jax_params_bit_for_bit(checkpoints, name):
    path, jparams, _ = checkpoints[name]
    cfg, jcfg = _cfgs(name)
    assert load_config(path, dtype=cfg.dtype) == cfg
    got = load_checkpoint(path, cfg, device="cpu")
    assert all(t.dtype == cfg.dtype for t in got.values())
    _assert_same(got, params_from_numpy(jparams, cfg, "cpu"))
    _assert_same(got, jax_weights.load_checkpoint(path, jcfg))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_streaming_int8_is_the_core_quantization(checkpoints, name):
    path, jparams, _ = checkpoints[name]
    cfg, _ = _cfgs(name)
    got = load_checkpoint(path, cfg, device="cpu", quantize_weights=True)
    assert got["wq"].dtype == torch.int8
    assert got["wq_scale"].dtype == torch.float32
    _assert_same(got, quantize_params(params_from_numpy(jparams, cfg,
                                                        "cpu")))
    _assert_same(got, jax_quantize_params(jparams))


def test_a_missing_or_misshaped_tensor_is_refused(checkpoints, tmp_path):
    path, jparams, _ = checkpoints["f32"]
    cfg, _ = _cfgs("f32")
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, dataclasses.replace(cfg, hidden_size=64),
                        device="cpu")
    with pytest.raises(KeyError, match="lm_head.weight"):
        tensors = hf_tensors(jparams, cfg)
        del tensors["lm_head.weight"]
        save_sharded(tensors, str(tmp_path), shards=1)
        load_checkpoint(str(tmp_path), cfg, device="cpu")


# ---------------------------------------------------------------- config

LLAMA_3_8B = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000, "eos_token_id": 128001,
    "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 8192,
    "model_type": "llama", "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 8, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 500000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 128256}
LLAMA_31_8B = {
    **LLAMA_3_8B, "eos_token_id": [128001, 128008, 128009],
    "max_position_embeddings": 131072, "mlp_bias": False,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"}}
QWEN25_05B = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151643, "hidden_act": "silu",
    "hidden_size": 896, "initializer_range": 0.02, "intermediate_size": 4864,
    "max_position_embeddings": 32768, "max_window_layers": 24,
    "model_type": "qwen2", "num_attention_heads": 14,
    "num_hidden_layers": 24, "num_key_value_heads": 2, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 32768,
    "tie_word_embeddings": True, "torch_dtype": "bfloat16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 151936}


def _write_config(path, hf: dict) -> str:
    path.mkdir(exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf))
    return str(path)


@pytest.mark.parametrize("hf,preset", [
    (LLAMA_3_8B, "llama-3-8b"), (LLAMA_31_8B, "llama-3.1-8b"),
    (QWEN25_05B, "qwen2.5-0.5b")], ids=["llama-3-8b", "llama-3.1-8b",
                                        "qwen2.5-0.5b"])
def test_load_config_agrees_with_the_reference(tmp_path, hf, preset):
    path = _write_config(tmp_path / "m", hf)
    got = load_config(path)
    want = jax_weights.load_config(path)
    assert got == get_preset(preset)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    for field in dataclasses.fields(got):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if field.name == "dtype":
            continue
        if field.name == "rope_scaling" and a is not None:
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, field.name
    # and hf_config writes what load_config reads back
    assert load_config(_write_config(tmp_path / "w", hf_config(
        got, hf["model_type"]))) == got


MIXTRAL_8X7B = {**LLAMA_3_8B, "architectures": ["MixtralForCausalLM"],
                "model_type": "mixtral", "vocab_size": 32000,
                "rope_theta": 1000000.0, "max_position_embeddings": 32768,
                "num_local_experts": 8, "num_experts_per_tok": 2}


def test_mixtral_config_loads_as_the_references(tmp_path):
    """Mixtral-8x7B's published config.json loads as a MixtralConfig equal
    field for field to the reference's from_hf_config, and equal to the
    port's preset."""
    from llmlb_tpu_torch.models.mixtral import MixtralConfig

    path = _write_config(tmp_path / "mixtral", MIXTRAL_8X7B)
    got, want = load_config(path), jax_weights.load_config(path)
    assert isinstance(got, MixtralConfig)
    assert type(want).__name__ == "MixtralConfig"
    assert got == get_preset("mixtral-8x7b")
    for field in dataclasses.fields(got):
        if field.name != "dtype":
            assert getattr(got, field.name) == getattr(want, field.name), \
                field.name
    assert load_config(_write_config(tmp_path / "w", hf_config(got))) == got


def test_unknown_rope_scaling_is_refused(tmp_path):
    yarn = {**LLAMA_3_8B, "rope_scaling": {"rope_type": "yarn",
                                           "factor": 4.0}}
    path = _write_config(tmp_path / "yarn", yarn)
    with pytest.raises(NotImplementedError) as ours:
        load_config(path)
    with pytest.raises(NotImplementedError) as theirs:
        jax_weights.load_config(path)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("quantize", [False, True])
def test_mixtral_checkpoint_is_the_references(tmp_path, quantize):
    """A tiny Mixtral HF checkpoint (block_sparse_moe.gate, experts.{e}.w1 /
    w3 / w2) written from the reference's debug-moe-tiny weights loads as
    those weights bit for bit, and as the JAX package's load of the same
    directory; with int8 weights, as both packages' quantize_params."""
    from llmlb_tpu.models import mixtral as jmixtral

    cfg, jcfg = get_preset("debug-moe-tiny"), jax_preset("debug-moe-tiny")
    jparams = {k: np.asarray(v) for k, v in jmixtral.init_params(
        jcfg, jax.random.PRNGKey(0)).items()}
    tensors = hf_tensors(jparams, cfg)
    assert "model.layers.1.block_sparse_moe.experts.3.w2.weight" in tensors
    save_sharded(tensors, str(tmp_path), shards=2)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf_config(cfg), f)
    assert load_config(str(tmp_path), dtype=torch.float32) == cfg
    got = load_checkpoint(str(tmp_path), cfg, device="cpu",
                          quantize_weights=quantize)
    want = params_from_numpy(jparams, cfg, "cpu")
    ref = jax_weights.load_checkpoint(str(tmp_path), jcfg,
                                      quantize_weights=quantize)
    if quantize:
        assert got["we_gate"].dtype == torch.int8
        assert tuple(got["we_down_scale"].shape) == (2, 4, 64)
        want = quantize_params(want)
    _assert_same(got, want)
    _assert_same(got, ref)


# ------------------------------------------------------------- tokenizer


def test_hf_tokenizer_is_the_references(checkpoints):
    path = checkpoints["bf16"][0]
    ours, theirs = HFTokenizer(path), JaxHFTokenizer(path)
    assert ours.eos_id == theirs.eos_id is not None
    text = "the lazy painter names colours"
    ids = ours.encode(text)
    assert ids == theirs.encode(text) and ids[0] == ours._tok.bos_token_id
    assert ours.decode(ids) == theirs.decode(ids) == text  # BOS skipped
    chat = ours.apply_chat_template(MESSAGES)
    assert chat == theirs.apply_chat_template(MESSAGES)
    assert chat.endswith("<|assistant|>")
    ours._tok.chat_template = theirs._tok.chat_template = None
    assert ours.apply_chat_template(MESSAGES) == \
        theirs.apply_chat_template(MESSAGES)


# ---------------------------------------------------------- --checkpoint


CORE_KW = dict(num_slots=2, slot_capacity=128, prefill_buckets=(16, 32, 64),
               kv_page_size=16)
MAX_TOKENS = 12


def test_main_serves_a_checkpoint_with_the_jax_engines_tokens(
        checkpoints, monkeypatch):
    path = checkpoints["bf16"][0]
    from llmlb_tpu_torch.engine import service as port_service

    jax_load, port_load = jax_weights.load_config, port_service.load_config
    monkeypatch.setattr(jax_weights, "load_config",
                        lambda d, dtype=None: jax_load(d, jnp.float32))
    monkeypatch.setattr(port_service, "load_config",
                        lambda d, dtype=None: port_load(d, torch.float32))
    jax_engine = JaxEngine.from_checkpoint(
        path, kv_layout="paged", prefix_cache=False, decode_burst=1,
        **CORE_KW)
    try:
        prompt = jax_engine.encode_chat(MESSAGES)
        req = jax_engine.core.submit(JaxRequest(
            prompt_ids=prompt, sampling=JaxSampling(
                temperature=0.0, max_tokens=MAX_TOKENS)))
        want = []
        while True:
            kind, value = req.events.get(timeout=120)
            if kind != "token":
                break
            want.append(int(value))
    finally:
        jax_engine.shutdown()

    started = {}

    class Capturing(server_mod.EngineHTTPServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            started["server"] = self

    monkeypatch.setattr(server_mod, "EngineHTTPServer", Capturing)
    monkeypatch.setattr(server_mod.signal, "signal", lambda *a: None)
    argv = ["--checkpoint", path, "--device", "cpu", "--port", "0",
            "--num-slots", "2", "--slot-capacity", "128",
            "--prefill-buckets", "16,32,64", "--kv-page-size", "16",
            "--prefix-cache", "off"]
    assert server_mod.build_parser().parse_args(argv).checkpoint == path
    thread = threading.Thread(target=server_mod.main, args=(argv,),
                              daemon=True)
    thread.start()
    deadline = time.monotonic() + 120
    while "server" not in started and time.monotonic() < deadline:
        time.sleep(0.01)
    srv = started["server"]
    try:
        base = "http://%s:%d" % srv.server_address[:2]
        body = {"model": "x", "messages": MESSAGES, "temperature": 0,
                "max_tokens": MAX_TOKENS, "stream": True,
                "llmlb_replay": True}
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read()
        ids = [t for line in raw.split(b"\n") if line.startswith(b"data: {")
               for obj in [json.loads(line[len(b"data: "):])]
               if obj.get("object") == "llmlb.replay" for t in obj["tokens"]]
        assert ids == want and ids
        engine = srv.engine
        assert engine.model_id == path.rstrip("/").split("/")[-1]
        assert engine.encode_chat(MESSAGES) == prompt
        assert engine.core.cfg.dtype == torch.float32
        assert engine.core.eos_id == engine.tokenizer.eos_id
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
