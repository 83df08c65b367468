"""The port's GGUF reader (``dynamo_tpu_torch/models/gguf.py``) against the
reference's (``dynamo_tpu/models/gguf.py``), on files this module writes.

- The reader: one tensor of each ggml type the reader takes (F32, F16,
  BF16, Q8_0, Q4_0, Q4_K, Q6_K; the K-quants as random blocks with sane
  scales) reads into the same array in both packages, bit for bit.
- The loader: a tiny Llama written as llama.cpp's converter writes it (Q/K
  rows permuted into interleaved-rope order) with its weights spread over
  F32, F16, Q8_0, Q4_0, Q4_K and Q6_K, tied and untied heads: the port's
  ``load_gguf_params`` gives the reference's tree as torch tensors, every
  leaf equal bit for bit in float32 and in bfloat16, and the same config.
- The card and the worker route: ``ModelDeploymentCard.from_local_path``
  on a ``.gguf`` file gives the reference's card, and the worker's
  ``build_engine`` on it (``--device cpu``) serves the greedy streams
  ``JaxEngine`` serves on the reference's load of the same file.
- ``chip_smoke.py``'s own streaming GGUF writer: what it writes reads back
  through both readers as written.
"""

import struct

import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.models.gguf import GgufFile as JGguf
from dynamo_tpu.models.gguf import load_gguf_params as jload
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models.gguf import GgufFile, load_gguf_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)

torch.set_num_threads(2)

_U32, _F32T, _STR, _ARR = 4, 6, 8, 9
F32, F16, Q4_0, Q8_0, Q4_K, Q6_K, BF16 = 0, 1, 2, 8, 12, 14, 30


def _str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _kv(key: str, vtype: int, value) -> bytes:
    out = _str(key) + struct.pack("<I", vtype)
    if vtype == _U32:
        return out + struct.pack("<I", value)
    if vtype == _F32T:
        return out + struct.pack("<f", value)
    if vtype == _STR:
        return out + _str(value)
    elem, items = value
    out += struct.pack("<I", elem) + struct.pack("<Q", len(items))
    return out + b"".join(_str(i) for i in items)


def write_gguf(path, metadata, tensors, align=32):
    """GGUF v3: ``tensors`` is ``[(name, shape, ggml_type, raw bytes)]``."""
    head = bytearray(b"GGUF" + struct.pack("<IQQ", 3, len(tensors),
                                           len(metadata)))
    for key, vtype, value in metadata:
        head += _kv(key, vtype, value)
    datas, offset = [], 0
    for name, shape, gtype, raw in tensors:
        head += _str(name) + struct.pack("<I", len(shape))
        for d in reversed(shape):               # innermost first
            head += struct.pack("<Q", d)
        head += struct.pack("<IQ", gtype, offset)
        pad = (-len(raw)) % align
        datas.append(raw + b"\0" * pad)
        offset += len(raw) + pad
    with open(path, "wb") as f:
        f.write(bytes(head) + b"\0" * ((-len(head)) % align)
                + b"".join(datas))


def _f16(x) -> bytes:
    return np.asarray(x, np.float16).tobytes()


def encode(x: np.ndarray, gtype: int, rng) -> bytes:
    """``x``'s bytes as ggml type ``gtype``: exact for the float types, the
    public quantizers for Q8_0 / Q4_0, random blocks (scales 0.002-0.03)
    for the K-quants, whose values then come from the blocks alone."""
    flat = x.reshape(-1)
    if gtype == F32:
        return flat.astype("<f4").tobytes()
    if gtype == F16:
        return flat.astype("<f2").tobytes()
    if gtype == BF16:
        return (flat.astype("<f4").view("<u4") >> 16).astype("<u2").tobytes()
    if gtype == Q8_0:
        b = flat.reshape(-1, 32)
        d = np.abs(b).max(axis=1, keepdims=True) / 127.0
        q = np.round(np.divide(b, d, out=np.zeros_like(b), where=d > 0))
        return b"".join(_f16(di) + qi.astype(np.int8).tobytes()
                        for di, qi in zip(d[:, 0], q))
    if gtype == Q4_0:
        out = b""
        for blk in flat.reshape(-1, 32):
            d = blk[np.argmax(np.abs(blk))] / -8.0
            q = (np.clip(np.round(blk / d) if d else np.zeros(32), -8, 7)
                 + 8).astype(np.uint8)
            out += _f16(d) + (q[:16] | (q[16:] << 4)).astype(np.uint8).tobytes()
        return out
    n = flat.size // 256
    if gtype == Q4_K:
        return b"".join(
            _f16(rng.uniform(0.002, 0.03)) + _f16(rng.uniform(0.002, 0.03))
            + rng.integers(0, 256, 140, dtype=np.uint8).tobytes()
            for _ in range(n))
    assert gtype == Q6_K
    return b"".join(
        rng.integers(0, 256, 192, dtype=np.uint8).tobytes()
        + rng.integers(-128, 128, 16).astype(np.int8).tobytes()
        + _f16(rng.uniform(0.002, 0.03)) for _ in range(n))


def _permute_qk(w: np.ndarray, n_head: int) -> np.ndarray:
    """llama.cpp's converter: HF rows -> interleaved-rope rows per head."""
    out_dim, in_dim = w.shape
    return (w.reshape(n_head, 2, out_dim // n_head // 2, in_dim)
            .swapaxes(1, 2).reshape(out_dim, in_dim))


V, H, I, L, NH, NKV, DH = 256, 64, 256, 2, 4, 2, 16
# each weight family's ggml type (every type the reader takes appears)
TYPES = {"token_embd.weight": F32, "output_norm.weight": F32,
         "output.weight": Q8_0, "attn_norm.weight": F32,
         "attn_q.weight": F16, "attn_k.weight": BF16, "attn_v.weight": Q8_0,
         "attn_output.weight": Q4_0, "ffn_norm.weight": F32,
         "ffn_gate.weight": Q4_K, "ffn_up.weight": Q6_K,
         "ffn_down.weight": Q8_0}


def make_model(path, tied: bool, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    md = [("general.architecture", _STR, "llama"),
          ("general.alignment", _U32, 32),
          ("llama.block_count", _U32, L),
          ("llama.embedding_length", _U32, H),
          ("llama.feed_forward_length", _U32, I),
          ("llama.attention.head_count", _U32, NH),
          ("llama.attention.head_count_kv", _U32, NKV),
          ("llama.attention.key_length", _U32, DH),
          ("llama.rope.freq_base", _F32T, 10000.0),
          ("llama.attention.layer_norm_rms_epsilon", _F32T, 1e-5),
          ("llama.context_length", _U32, 512),
          ("tokenizer.ggml.tokens", _ARR, (_STR, [f"t{i}" for i in range(V)])),
          ("tokenizer.ggml.eos_token_id", _U32, 2),
          ("tokenizer.ggml.bos_token_id", _U32, 1),
          ("tokenizer.chat_template", _STR, "{{ messages }}")]
    shapes = {"token_embd.weight": (V, H), "output_norm.weight": (H,),
              "output.weight": (V, H), "attn_norm.weight": (H,),
              "attn_q.weight": (NH * DH, H), "attn_k.weight": (NKV * DH, H),
              "attn_v.weight": (NKV * DH, H),
              "attn_output.weight": (H, NH * DH), "ffn_norm.weight": (H,),
              "ffn_gate.weight": (I, H), "ffn_up.weight": (I, H),
              "ffn_down.weight": (H, I)}
    tensors = []
    for key, shape in shapes.items():
        if key == "output.weight" and tied:
            continue
        names = [key] if key.startswith(("token_", "output")) else \
            [f"blk.{i}.{key}" for i in range(L)]
        for name in names:
            x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
            if key.endswith("norm.weight"):
                x = 1.0 + 0.1 * x
            if key == "attn_q.weight":
                x = _permute_qk(x, NH)
            elif key == "attn_k.weight":
                x = _permute_qk(x, NKV)
            tensors.append((name, shape, TYPES[key], encode(x, TYPES[key],
                                                            rng)))
    write_gguf(path, md, tensors)


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("gtype,shape", [
    (F32, (3, 32)), (F16, (5, 64)), (BF16, (4, 32)), (Q8_0, (8, 64)),
    (Q4_0, (4, 64)), (Q4_K, (3, 256)), (Q6_K, (2, 512))])
def test_reader_equals_reference(tmp_path, gtype, shape):
    rng = np.random.default_rng(gtype)
    x = rng.standard_normal(shape).astype(np.float32)
    path = str(tmp_path / "t.gguf")
    write_gguf(path, [("general.architecture", _STR, "llama")],
               [("w", shape, gtype, encode(x, gtype, rng))])
    got = GgufFile(path).load_tensor("w")
    want = JGguf(path).load_tensor("w")
    assert got.dtype == want.dtype and got.shape == want.shape == shape
    assert np.array_equal(got, want, equal_nan=True)
    assert np.isfinite(got).all()
    if gtype in (F32, F16, BF16):
        exact = {F32: x, F16: x.astype(np.float16),
                 BF16: (x.view(np.uint32) & 0xFFFF0000).view(np.float32)}
        assert np.array_equal(got, exact[gtype])


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_equal_reference(tmp_path, tied, dtype):
    path = str(tmp_path / "m.gguf")
    make_model(path, tied)
    cfg = GgufFile(path).to_model_config(dtype=dtype)
    jcfg = JGguf(path).to_model_config(dtype=dtype)
    assert cfg.__dict__ == jcfg.__dict__
    assert cfg.tie_word_embeddings == tied and cfg.head_dim == DH
    got = dict(_leaves(load_gguf_params(cfg, path, device="cpu")))
    want = dict(_leaves(jload(jcfg, path)))
    assert sorted(got) == sorted(want)
    assert (("lm_head",) in got) != tied
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[dtype], key
        assert tuple(g.shape) == tuple(w.shape), key
        assert np.array_equal(_bits(g), _bits(w)), key


def test_card_equals_reference(tmp_path):
    path = str(tmp_path / "tiny-llama.gguf")
    make_model(path, tied=True)
    card = ModelDeploymentCard.from_local_path(path)
    ref = JCard.from_local_path(path)
    assert card.name == ref.name == "tiny-llama"
    for field in ("model_path", "context_length", "eos_token_ids",
                  "bos_token_id", "chat_template"):
        assert getattr(card, field) == getattr(ref, field), field
    assert card.eos_token_ids == [2] and card.bos_token_id == 1


async def _greedy(engine, Req, Samp, Stop):
    rng = np.random.default_rng(3)
    out = []
    try:
        for i, n in enumerate((9, 30, 1)):
            req = Req(token_ids=list(map(int, rng.integers(3, V, size=n))),
                      request_id=f"r{i}",
                      stop_conditions=Stop(max_tokens=6, ignore_eos=True),
                      sampling_options=Samp(temperature=0.0))
            toks = []
            async for frame in engine.generate(req):
                toks += frame.token_ids
            out.append(toks)
    finally:
        await engine.stop()
    return out


@pytest.mark.async_timeout(120)
async def test_worker_serves_a_gguf_file_as_jax_engine(tmp_path):
    """The worker's ``.gguf`` route: ``build_engine`` reads the config and
    the weights from the file; its greedy streams equal ``JaxEngine``'s on
    the reference's load of the same file (float32)."""
    from dynamo_tpu_torch.worker.main import build_engine, build_parser
    path = str(tmp_path / "m.gguf")
    make_model(path, tied=False)
    sizes = ["--num-pages", "64", "--page-size", "4", "--max-num-seqs", "4",
             "--max-prefill-chunk", "16", "--max-context", "128"]
    args = build_parser().parse_args(
        ["--model-path", path, "--device", "cpu", "--dtype", "float32",
         "--decode-multistep", "1", *sizes])
    teng = build_engine(args)
    assert teng.device.type == "cpu" and teng.model_cfg.num_layers == L
    jcfg = JGguf(path).to_model_config(dtype="float32")
    jeng = JaxEngine(jcfg, jload(jcfg, path), JaxEngineConfig(
        attn_impl="scan", num_pages=64, page_size=4, max_num_seqs=4,
        max_prefill_chunk=16, max_context=128, decode_multistep=1))
    want = await _greedy(jeng, JRequest, JSampling, JStop)
    got = await _greedy(teng, TRequest, TSampling, TStop)
    assert got == want and all(len(t) == 6 for t in got)


def test_chip_smoke_writer_reads_back(tmp_path):
    """``chip_smoke.write_gguf`` streams tensors to the file one at a time
    (F16 as given, Q8_0 through ``chip_smoke.q8_0_blocks``): both readers
    read back what it wrote, the Q8_0 tensor as the blocks dequantize."""
    import chip_smoke as cs
    rng = np.random.default_rng(7)
    a = rng.standard_normal((6, 64)).astype(np.float16)
    b = rng.standard_normal((4, 96)).astype(np.float32)
    path = str(tmp_path / "c.gguf")
    cs.write_gguf(path, [("general.architecture", "llama"),
                         ("llama.block_count", 1),
                         ("llama.rope.freq_base", 500000.0)],
                  [("a", a.shape, cs.GGML_F16, lambda: a.tobytes()),
                   ("b", b.shape, cs.GGML_Q8_0,
                    lambda: cs.q8_0_blocks(torch.from_numpy(b)))])
    for reader in (GgufFile, JGguf):
        gf = reader(path)
        assert gf.metadata["llama.block_count"] == 1
        assert gf.metadata["llama.rope.freq_base"] == 500000.0
        assert np.array_equal(gf.load_tensor("a"), a)
        assert np.abs(gf.load_tensor("b") - b).max() <= \
            np.abs(b).max() / 127.0
    assert np.array_equal(GgufFile(path).load_tensor("b"),
                          JGguf(path).load_tensor("b"))
