"""The port's Llama forward against ``dynamo_tpu.models.llama.forward``.

One parameter tree from the reference's ``init_params`` goes to both
packages (``params_from_jax``); the same prefill, mixed (a chunk over a
cached prefix next to a decode row) and decode steps run through both on
their own caches, in float32: logits within 1e-4 and the pages within
1e-5. A qk-norm + attention-bias variant (qwen) runs too, with the norms
and biases perturbed so they matter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.kernels.decode import paged_decode_attention_stacked
from dynamo_tpu_torch.ops.kernels.prefill import (
    paged_prefill_attention_stacked)
from dynamo_tpu_torch.ops.kernels.ragged import ragged_mixed_attention_stacked

# small CPU shapes: keep torch off the cores other test workers time on
torch.set_num_threads(2)

LOGIT_TOL = 1e-4
PAGE_TOL = 1e-5
PS, P, N = 4, 16, 40


def _params(cfg_kw, seed=0):
    jcfg = JModelConfig.tiny(**cfg_kw)
    tree = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)
    rng = np.random.default_rng(seed)
    lay = np_tree["layers"]
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in lay:
            lay[name] = lay[name] + rng.normal(
                scale=0.1, size=lay[name].shape).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    cfg = ModelConfig.tiny(**cfg_kw)
    return jcfg, jparams, cfg, tllama.params_from_jax(np_tree, cfg,
                                                      device="cpu")


def _steps(vocab):
    """(name, tokens, positions, table, total, new) for a prefill of two
    rows (one short, padded), a mixed step (row 0's next chunk over its
    cached prefix + row 1 decoding) and a decode step."""
    rng = np.random.default_rng(3)
    table = np.zeros((2, P), np.int32)
    table[0, :6] = np.arange(1, 7)
    table[1, :6] = np.arange(7, 13)
    prompt = rng.integers(0, vocab, size=(2, 14)).astype(np.int32)
    out = []
    toks = np.zeros((2, 8), np.int32)
    toks[0] = prompt[0, :8]
    toks[1, :5] = prompt[1, :5]
    pos = np.zeros((2, 8), np.int32)
    pos[0] = np.arange(8)
    pos[1, :5] = np.arange(5)
    out.append(("prefill", toks, pos, table, [8, 5], [8, 5]))
    toks = np.zeros((2, 6), np.int32)
    toks[0] = prompt[0, 8:14]
    toks[1, 0] = prompt[1, 5]
    pos = np.zeros((2, 6), np.int32)
    pos[0] = np.arange(8, 14)
    pos[1, 0] = 5
    out.append(("mixed", toks, pos, table, [14, 6], [6, 1]))
    out.append(("decode", np.array([[3], [4]], np.int32),
                np.array([[14], [6]], np.int32), table, [15, 7], [1, 1]))
    return out


def _run_both(cfg_kw, kernels=False):
    jcfg, jparams, cfg, tparams = _params(cfg_kw)
    jpages = jllama.make_pages(jcfg, N, PS)
    tpages = tllama.make_pages(cfg, N, PS)
    attn = {"prefill": paged_prefill_attention_stacked,
            "mixed": ragged_mixed_attention_stacked,
            "decode": paged_decode_attention_stacked}
    for name, toks, pos, table, total, new in _steps(cfg.vocab_size):
        args = [np.asarray(x, np.int32) for x in (toks, pos, table, total,
                                                   new)]
        jl, jpages = jllama.forward(jparams, jcfg, *(jnp.asarray(a) for a in
                                                     args[:2]), jpages,
                                    *(jnp.asarray(a) for a in args[2:]))
        with torch.no_grad():
            tl, tpages = tllama.forward(
                tparams, cfg, *(torch.from_numpy(a) for a in args[:2]),
                tpages, *(torch.from_numpy(a) for a in args[2:]),
                attn_impl=attn[name] if kernels else None)
        assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
        err = float(np.max(np.abs(np.asarray(jl) - tl.numpy())))
        assert err <= LOGIT_TOL, (name, err)
        # every real page; the garbage page 0 holds pad slots' K/V, which
        # differ once pad query slots come out zero from the kernels
        first = 1 if kernels else 0
        perr = float(np.max(np.abs(np.asarray(jpages)[:, first:]
                                   - tpages.numpy()[:, first:])))
        assert perr <= PAGE_TOL, (name, perr)


@pytest.mark.parametrize("variant", [
    {}, {"qk_norm": True, "attention_bias": True},
    {"tie_word_embeddings": True}])
def test_forward_matches_jax(variant):
    _run_both(variant)


def test_forward_through_kernel_wrappers_matches_jax():
    """The engine's attention path (the kernels' wrappers, computing their
    plain versions on CPU tensors) at a kernel-shaped head dim."""
    _run_both({"num_heads": 4, "num_kv_heads": 2, "head_dim": 128},
              kernels=True)


def test_make_pages_layout():
    cfg = ModelConfig.tiny()
    pages = tllama.make_pages(cfg, 9, 4)
    assert pages.shape == (cfg.num_layers, 9, 2, cfg.num_kv_heads, 4,
                           cfg.head_dim)
    assert pages.dtype == torch.float32 and not bool(pages.any())


def test_init_params_seeded_on_device():
    cfg = ModelConfig.tiny()
    a = tllama.init_params(cfg, torch.Generator().manual_seed(5),
                           device="cpu")
    b = tllama.init_params(cfg, torch.Generator().manual_seed(5),
                           device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert a["layers"]["wq"].shape == (cfg.num_layers, cfg.hidden_size,
                                       cfg.q_size)
    assert ("lm_head" in a) == (not cfg.tie_word_embeddings)


LLAMA_TREE = {
    "llama": ("LlamaConfig", dict(tie_word_embeddings=True,
                                  rope_theta=500000.0,
                                  rope_scaling={
                                      "rope_type": "llama3", "factor": 32.0,
                                      "low_freq_factor": 1.0,
                                      "high_freq_factor": 4.0,
                                      "original_max_position_embeddings":
                                          8192})),
    "mistral": ("MistralConfig", dict(sliding_window=4096)),
    "qwen2": ("Qwen2Config", dict(tie_word_embeddings=True)),
    "qwen3": ("Qwen3Config", dict(head_dim=32)),
}


@pytest.mark.parametrize("family", list(LLAMA_TREE))
def test_from_hf_matches_reference_field_by_field(family, tmp_path):
    """The Llama tree's ``from_hf``: a tiny ``*ForCausalLM`` config written
    by transformers, parsed by both packages, gives equal configs in every
    field."""
    import dataclasses

    import transformers
    name, kw = LLAMA_TREE[family]
    hf = getattr(transformers, name)(
        vocab_size=320, hidden_size=64, intermediate_size=160,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=1024, rms_norm_eps=1e-6,
        architectures=[name.replace("Config", "ForCausalLM")], **kw)
    hf.save_pretrained(tmp_path)
    got = ModelConfig.from_pretrained(str(tmp_path), dtype="float32")
    want = JModelConfig.from_pretrained(str(tmp_path), dtype="float32")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model_type == family
    assert (got.num_layers, got.num_heads, got.num_kv_heads) == (3, 4, 2)
    assert got.head_dim == kw.get("head_dim", 16)
    assert got.qk_norm == (family == "qwen3")
