"""GGUF single-file model support: metadata, config, tokenizer vocab, weights.

Parity: reference ``lib/llm/src/gguf/*.rs`` (GGUF metadata/tokenizer parsing
for llama.cpp-style models, used by ``LocalModel`` and the model card). This
reader is written from the public GGUF v3 layout:

  header:  magic "GGUF" | version u32 | tensor_count u64 | kv_count u64
  kv:      key string | value_type u32 | value
  tensors: name string | n_dims u32 | dims u64[n] | ggml_type u32 | offset u64
  data:    aligned to general.alignment (default 32)

Weights load into the same stacked-layer pytree the HF loader produces
(llama.cpp ``blk.N.*`` naming). Unquantized ggml types (F32, F16, BF16) load
directly; the common quantized types (Q4_0, Q8_0, Q4_K, Q6_K — the formats
llama.cpp's default Q4_K_M / Q8_0 exports use) dequantize to float on load
from the public ggml block layouts. Other quantized types raise a clear
error.

llama-arch Q/K layout: llama.cpp's HF converter permutes attn_q/attn_k rows
per head into interleaved-rope order; this loader applies the inverse so the
weights match this repo's rotate-half rope (``ops/rope.py``).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from dynamo_tpu_torch.models.config import ModelConfig

GGUF_MAGIC = b"GGUF"

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = \
    range(13)

_SCALAR_FMT = {_U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I",
               _I32: "<i", _F32: "<f", _U64: "<Q", _I64: "<q", _F64: "<d"}

# ggml tensor types we can load without dequantization
GGML_F32, GGML_F16 = 0, 1
GGML_BF16 = 30
_TENSOR_DTYPES = {GGML_F32: np.dtype("<f4"), GGML_F16: np.dtype("<f2"),
                  GGML_BF16: np.dtype("<u2")}  # bf16 read as raw u16

# quantized ggml types: type -> (elements per block, bytes per block)
GGML_Q4_0, GGML_Q8_0, GGML_Q4_K, GGML_Q6_K = 2, 8, 12, 14
_QUANT_BLOCKS = {GGML_Q4_0: (32, 18), GGML_Q8_0: (32, 34),
                 GGML_Q4_K: (256, 144), GGML_Q6_K: (256, 210)}


def _f16_col(b: np.ndarray) -> np.ndarray:
    """Two uint8 columns -> float32 column vector."""
    return b.copy().view(np.float16).astype(np.float32)


def _dequant_q8_0(b: np.ndarray) -> np.ndarray:
    # block: f16 d | 32x int8 q;  v = d*q
    d = _f16_col(b[:, 0:2])
    q = b[:, 2:].copy().view(np.int8).astype(np.float32)
    return d * q


def _dequant_q4_0(b: np.ndarray) -> np.ndarray:
    # block: f16 d | 16 bytes of nibbles; elem j = lo(qs[j]), j+16 = hi(qs[j])
    d = _f16_col(b[:, 0:2])
    qs = b[:, 2:]
    lo = (qs & 0xF).astype(np.float32) - 8.0
    hi = (qs >> 4).astype(np.float32) - 8.0
    return d * np.concatenate([lo, hi], axis=1)


def _q4k_scales(sc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte packed 6-bit (scale, min) pairs of a K-quant
    super-block into [nb, 8] float arrays."""
    sc = sc.astype(np.uint16)
    nb = sc.shape[0]
    scales = np.empty((nb, 8), np.float32)
    mins = np.empty((nb, 8), np.float32)
    for j in range(4):
        scales[:, j] = sc[:, j] & 63
        mins[:, j] = sc[:, j + 4] & 63
    for j in range(4, 8):
        scales[:, j] = (sc[:, j + 4] & 0xF) | ((sc[:, j - 4] >> 6) << 4)
        mins[:, j] = (sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4)
    return scales, mins


def _dequant_q4_k(b: np.ndarray) -> np.ndarray:
    # super-block (256): f16 d | f16 dmin | 12B packed 6-bit scales/mins |
    # 128B nibbles; sub-block 2j = lo nibbles of chunk j, 2j+1 = hi nibbles;
    # v = d*sc*q - dmin*m
    d = _f16_col(b[:, 0:2])
    dmin = _f16_col(b[:, 2:4])
    scales, mins = _q4k_scales(b[:, 4:16])
    qs = b[:, 16:144]
    out = np.empty((b.shape[0], 256), np.float32)
    for j in range(4):
        q = qs[:, 32 * j:32 * j + 32]
        lo = (q & 0xF).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        out[:, 64 * j:64 * j + 32] = (
            d * scales[:, [2 * j]] * lo - dmin * mins[:, [2 * j]])
        out[:, 64 * j + 32:64 * j + 64] = (
            d * scales[:, [2 * j + 1]] * hi - dmin * mins[:, [2 * j + 1]])
    return out


def _dequant_q6_k(b: np.ndarray) -> np.ndarray:
    # super-block (256): 128B ql (low nibbles) | 64B qh (2-bit highs) |
    # 16x int8 scales (one per 16 elems) | f16 d;  v = d*scale*(q-32)
    ql_all = b[:, 0:128]
    qh_all = b[:, 128:192]
    scales = b[:, 192:208].copy().view(np.int8).astype(np.float32)
    d = _f16_col(b[:, 208:210])
    out = np.empty((b.shape[0], 256), np.float32)
    idx16 = np.arange(32) // 16  # scale index within a 32-elem quarter
    for half in range(2):
        ql = ql_all[:, 64 * half:64 * half + 64]
        qh = qh_all[:, 32 * half:32 * half + 32]
        sch = scales[:, 8 * half:8 * half + 8]
        base = 128 * half
        quarters = (
            ((ql[:, :32] & 0xF) | ((qh & 3) << 4), 0),
            ((ql[:, 32:] & 0xF) | (((qh >> 2) & 3) << 4), 2),
            ((ql[:, :32] >> 4) | (((qh >> 4) & 3) << 4), 4),
            ((ql[:, 32:] >> 4) | (((qh >> 6) & 3) << 4), 6),
        )
        for k, (q, s0) in enumerate(quarters):
            out[:, base + 32 * k:base + 32 * k + 32] = (
                d * sch[:, idx16 + s0] * (q.astype(np.float32) - 32.0))
    return out


_DEQUANT = {GGML_Q4_0: _dequant_q4_0, GGML_Q8_0: _dequant_q8_0,
            GGML_Q4_K: _dequant_q4_k, GGML_Q6_K: _dequant_q6_k}


def _read(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise ValueError("truncated GGUF file")
    return struct.unpack(fmt, data)[0]


def _read_string(f: BinaryIO) -> str:
    n = _read(f, "<Q")
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int):
    if vtype in _SCALAR_FMT:
        v = _read(f, _SCALAR_FMT[vtype])
        return v
    if vtype == _BOOL:
        return bool(_read(f, "<B"))
    if vtype == _STR:
        return _read_string(f)
    if vtype == _ARR:
        elem_type = _read(f, "<I")
        count = _read(f, "<Q")
        return [_read_value(f, elem_type) for _ in range(count)]
    raise ValueError(f"unknown GGUF metadata type {vtype}")


class GgufFile:
    """Parsed GGUF: metadata dict + tensor directory (lazy data loads)."""

    def __init__(self, path: str):
        self.path = path
        self.metadata: Dict[str, Any] = {}
        # name -> (shape, ggml_type, absolute_offset)
        self.tensors: Dict[str, Tuple[Tuple[int, ...], int, int]] = {}
        with open(path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise ValueError(f"{path} is not a GGUF file")
            version = _read(f, "<I")
            if version < 2:
                raise ValueError(f"unsupported GGUF version {version}")
            tensor_count = _read(f, "<Q")
            kv_count = _read(f, "<Q")
            for _ in range(kv_count):
                key = _read_string(f)
                vtype = _read(f, "<I")
                self.metadata[key] = _read_value(f, vtype)
            infos: List[Tuple[str, Tuple[int, ...], int, int]] = []
            for _ in range(tensor_count):
                name = _read_string(f)
                n_dims = _read(f, "<I")
                dims = tuple(_read(f, "<Q") for _ in range(n_dims))
                ggml_type = _read(f, "<I")
                offset = _read(f, "<Q")
                # GGUF dims are stored innermost-first; numpy wants outermost
                infos.append((name, tuple(reversed(dims)), ggml_type, offset))
            align = int(self.metadata.get("general.alignment", 32))
            base = f.tell()
            base = (base + align - 1) // align * align
            for name, shape, ggml_type, offset in infos:
                self.tensors[name] = (shape, ggml_type, base + offset)

    # -- tensor data -------------------------------------------------------

    def load_tensor(self, name: str) -> np.ndarray:
        shape, ggml_type, offset = self.tensors[name]
        count = int(np.prod(shape)) if shape else 1
        if ggml_type in _QUANT_BLOCKS:
            per_block, block_bytes = _QUANT_BLOCKS[ggml_type]
            if count % per_block:
                raise ValueError(
                    f"tensor {name!r}: {count} elements not divisible by "
                    f"the {per_block}-element quant block")
            n_blocks = count // per_block
            with open(self.path, "rb") as f:
                f.seek(offset)
                raw = f.read(n_blocks * block_bytes)
            if len(raw) != n_blocks * block_bytes:
                raise ValueError(f"truncated tensor data for {name!r}")
            blocks = np.frombuffer(raw, np.uint8).reshape(n_blocks,
                                                          block_bytes)
            return _DEQUANT[ggml_type](blocks).reshape(shape)
        dtype = _TENSOR_DTYPES.get(ggml_type)
        if dtype is None:
            raise NotImplementedError(
                f"tensor {name!r} uses unsupported ggml type {ggml_type}; "
                f"supported: F32/F16/BF16/Q4_0/Q8_0/Q4_K/Q6_K")
        with open(self.path, "rb") as f:
            f.seek(offset)
            raw = f.read(count * dtype.itemsize)
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
        if ggml_type == GGML_BF16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return np.ascontiguousarray(arr)

    # -- model config ------------------------------------------------------

    def to_model_config(self, dtype: str = "bfloat16") -> ModelConfig:
        md = self.metadata
        arch = md.get("general.architecture", "llama")

        def g(key, default=None):
            return md.get(f"{arch}.{key}", default)

        heads = int(g("attention.head_count"))
        hidden = int(g("embedding_length"))
        vocab = md.get(f"{arch}.vocab_size")
        if vocab is None:
            vocab = len(md.get("tokenizer.ggml.tokens", [])) or 32000
        return ModelConfig(
            vocab_size=int(vocab),
            hidden_size=hidden,
            intermediate_size=int(g("feed_forward_length")),
            num_layers=int(g("block_count")),
            num_heads=heads,
            num_kv_heads=int(g("attention.head_count_kv", heads)),
            head_dim=int(g("attention.key_length", hidden // heads)),
            rope_theta=float(g("rope.freq_base", 10000.0)),
            rms_norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
            max_position_embeddings=int(g("context_length", 8192)),
            tie_word_embeddings="output.weight" not in self.tensors,
            model_type=arch,
            dtype=dtype,
        )

    def special_token_ids(self) -> Dict[str, Optional[int]]:
        md = self.metadata
        return {
            "eos": md.get("tokenizer.ggml.eos_token_id"),
            "bos": md.get("tokenizer.ggml.bos_token_id"),
        }


# llama.cpp tensor name -> (pytree path, transpose?)
_GGUF_MAP = {
    "token_embd.weight": (("embed",), False),
    "output_norm.weight": (("final_norm",), False),
    "output.weight": (("lm_head",), True),
    "blk.{i}.attn_norm.weight": (("layers", "attn_norm"), False),
    "blk.{i}.attn_q.weight": (("layers", "wq"), True),
    "blk.{i}.attn_k.weight": (("layers", "wk"), True),
    "blk.{i}.attn_v.weight": (("layers", "wv"), True),
    "blk.{i}.attn_output.weight": (("layers", "wo"), True),
    "blk.{i}.ffn_norm.weight": (("layers", "mlp_norm"), False),
    "blk.{i}.ffn_gate.weight": (("layers", "w_gate"), True),
    "blk.{i}.ffn_up.weight": (("layers", "w_up"), True),
    "blk.{i}.ffn_down.weight": (("layers", "w_down"), True),
}


def _unpermute_rope_rows(w: np.ndarray, n_head: int) -> np.ndarray:
    """Invert llama.cpp's HF->GGUF per-head row permutation on a
    [out_features, in_features] Q/K weight.

    The converter maps row ``a*(d/2)+b -> 2b+a`` within each head
    (``w.reshape(H, 2, d/2, in).swapaxes(1, 2)``) to turn HF rotate-half
    layout into GGUF interleaved-rope layout; this applies the inverse so
    rotate-half rope sees the original HF rows.
    """
    out_dim, in_dim = w.shape
    head = out_dim // n_head
    return np.ascontiguousarray(
        w.reshape(n_head, head // 2, 2, in_dim)
        .swapaxes(1, 2)
        .reshape(out_dim, in_dim))


# architectures whose GGUF files carry converter-permuted Q/K (llama-arch
# covers Llama and Mistral exports)
_PERMUTED_QK_ARCHS = {"llama"}


def load_gguf_params(cfg: ModelConfig, path: str,
                     device=None) -> Dict[str, Any]:
    """Assemble the stacked-layer param pytree from a GGUF file, as torch
    tensors on ``device`` (None: the GPU)."""
    import torch

    from dynamo_tpu_torch.models.llama import torch_dtype
    from dynamo_tpu_torch.utils.device import resolve_device

    gf = GgufFile(path)
    arch = gf.metadata.get("general.architecture", "llama")
    staged: Dict[tuple, Any] = {}
    per_layer: Dict[tuple, Dict[int, np.ndarray]] = {}
    for name in gf.tensors:
        layer = None
        key = name
        if name.startswith("blk."):
            rest = name[len("blk."):]
            idx, _, tail = rest.partition(".")
            layer = int(idx)
            key = f"blk.{{i}}.{tail}"
        spec = _GGUF_MAP.get(key)
        if spec is None:
            continue
        tree_path, transpose = spec
        t = gf.load_tensor(name)
        if arch in _PERMUTED_QK_ARCHS:
            if key == "blk.{i}.attn_q.weight":
                t = _unpermute_rope_rows(t, cfg.num_heads)
            elif key == "blk.{i}.attn_k.weight":
                t = _unpermute_rope_rows(t, cfg.num_kv_heads)
        if transpose:
            t = np.ascontiguousarray(t.T)
        if layer is None:
            staged[tree_path] = t
        else:
            per_layer.setdefault(tree_path, {})[layer] = t

    for tree_path, by_layer in per_layer.items():
        missing = set(range(cfg.num_layers)) - set(by_layer)
        if missing:
            raise ValueError(f"GGUF missing layers {sorted(missing)} "
                             f"for {tree_path}")
        staged[tree_path] = np.stack(
            [by_layer[i] for i in range(cfg.num_layers)])

    expected = {tp for tp, _ in _GGUF_MAP.values()}
    if cfg.tie_word_embeddings:
        expected.discard(("lm_head",))
    absent = expected - set(staged)
    if absent:
        raise ValueError(f"GGUF at {path} missing weights for {sorted(absent)}")

    params: Dict[str, Any] = {}
    target = torch_dtype(cfg.dtype)
    dev = resolve_device(device)
    for tree_path, arr in staged.items():
        node = params
        for k in tree_path[:-1]:
            node = node.setdefault(k, {})
        node[tree_path[-1]] = torch.tensor(arr, device=dev).to(target)
    return params


__all__ = ["GgufFile", "load_gguf_params"]
