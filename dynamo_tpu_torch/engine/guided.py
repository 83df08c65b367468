"""Guided decoding: JSON / JSON-Schema constrained token masks.

The reference forwards OpenAI ``response_format`` to its CUDA engines
(``lib/llm/src/protocols/openai/chat_completions.rs`` carries the field;
vLLM/SGLang implement the constraint). This engine is native, so the
constraint machinery lives here, designed around the TPU split:

- ALL grammar work runs on the host: a byte-level pushdown automaton (JSON
  needs a stack for nesting) whose states are IMMUTABLE tuples — stepping
  returns a new state sharing structure, so exploring the token vocabulary
  trie needs no copying, and masks are cached per automaton state (states
  recur heavily: every "inside a string" step is the same state).
- the DEVICE sees one uint32 bit-packed allow-mask per row
  (``ceil(V/32)`` words, ~4 KB at a 32k vocab — rides the step's host
  arrays), unpacked with shift/and inside the jitted step
  (``ops/sampling.apply_vocab_mask``). No [B, V] float mask ever crosses
  the wire and no host round-trip is added.

Schema support is the OpenAI structured-outputs subset: ``type`` (all JSON
types, or a list), ``properties``/``required`` (objects are CLOSED — keys
outside ``properties`` are never generated, matching structured outputs'
``additionalProperties: false``), ``items``, ``enum``/``const`` of
primitives, ``anyOf``/``oneOf`` with first-byte-disjoint branches, and
local ``$ref``/``$defs`` (recursive schemas work — grammar nodes are ids).
Anything else raises :class:`GuidedUnsupported` at compile time — a loud
400, never a silently ignored constraint.
"""

from __future__ import annotations

import json
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

State = Tuple[Tuple, ...]          # immutable stack of frames, top = last
WS = frozenset(b" \t\n\r")
DONE: State = (("done",),)
# Whitespace between JSON tokens is capped per gap (canonical-ish output:
# "{\n  ..." styles are masked away, compact/single-space forms remain).
# Unbounded ws would let generation ramble blanks forever — with masks on,
# nothing ever forces progress, so the cap is what guarantees termination
# pressure toward EOS; none is allowed after the document completes.
MAX_WS = 2
# JSON numbers are capped in byte length for the same reason: nothing in a
# grammar mask ever forces a number to END, so an unbounded number is an
# unbounded blank check. 24 bytes comfortably covers every i64/f64.
MAX_NUM_LEN = 24

_ESCAPABLE = frozenset(b'"\\/bfnrtu')
_HEX = frozenset(b"0123456789abcdefABCDEF")
_DIGITS = frozenset(b"0123456789")


class GuidedUnsupported(ValueError):
    """Schema uses a keyword/shape this implementation cannot enforce."""


# --------------------------------------------------------------------------
# grammar compilation


class Grammar:
    """Compiled schema: a node table + flattened literal tries.

    nodes[i] is a tuple whose head names the kind:
      ("any",)                      any JSON value
      ("obj", keys, props, req)     object; keys = lit-trie id over the
                                    property names (None = open/any keys),
                                    props = {key: value node id},
                                    req = frozenset of required keys
      ("arr", item_nid)
      ("str",) ("num", int_only) ("bool",) ("null",)
      ("enum", trie_id)             literal values by canonical encoding
      ("union", dispatch)           dispatch = {first_byte: node id}

    Literal tries are flat int-indexed nodes (frames stay hashable):
    ``lit_edges[trie_id][node] -> {byte: node}``;
    ``lit_ends[trie_id][node] -> payload`` marks literal completion.
    """

    def __init__(self) -> None:
        self.nodes: List[Tuple] = []
        self.lit_edges: List[List[Dict[int, int]]] = []
        self.lit_ends: List[Dict[int, Any]] = []
        self.lit_reach: List[List[FrozenSet]] = []

    # -- literal tries -----------------------------------------------------

    def add_trie(self, literals: Dict[bytes, Any]) -> int:
        """Flatten {literal bytes: completion payload} into one trie.

        Also records, per trie node, the frozenset of payloads reachable
        at or below it — object-key walks prune on it so a step can never
        enter a subtree whose every key is already used (a mid-literal
        dead end would zero the mask and drop the constraint)."""
        edges: List[Dict[int, int]] = [{}]
        ends: Dict[int, Any] = {}
        touched: List[List[Any]] = [[]]
        for lit, payload in literals.items():
            node = 0
            touched[0].append(payload)
            for b in lit:
                nxt = edges[node].get(b)
                if nxt is None:
                    nxt = len(edges)
                    edges.append({})
                    touched.append([])
                    edges[node][b] = nxt
                node = nxt
                touched[node].append(payload)
            if node in ends:
                raise GuidedUnsupported(
                    f"duplicate literal {lit!r} in enum/property set")
            ends[node] = payload
        self.lit_edges.append(edges)
        self.lit_ends.append(ends)
        self.lit_reach.append([frozenset(t) for t in touched])
        return len(self.lit_edges) - 1

    # -- schema compilation ------------------------------------------------

    root: int = 0   # node id generation starts from (see initial_state)

    @classmethod
    def any_json(cls) -> "Grammar":
        g = cls()
        g.nodes.append(("any",))
        return g

    @classmethod
    def any_object(cls) -> "Grammar":
        """OpenAI ``json_object`` mode: the root is an object, its contents
        are any valid JSON."""
        g = cls()
        g.nodes.append(("obj", None, None, frozenset()))
        return g

    @classmethod
    def from_schema(cls, schema: Dict[str, Any]) -> "Grammar":
        g = cls()
        root = schema if isinstance(schema, dict) else None
        if root is None:
            raise GuidedUnsupported("json_schema.schema must be an object")
        defs = {}
        for key in ("$defs", "definitions"):
            for name, sub in (root.get(key) or {}).items():
                defs[f"#/{key}/{name}"] = sub
        g._defs = defs
        g._ref_ids: Dict[str, int] = {}
        # composite schemas (unions, type lists) compile their branch
        # nodes FIRST — the root is whatever _compile returns, not node 0
        g.root = g._compile(root)
        g._finalize_unions()
        return g

    def _finalize_unions(self) -> None:
        """Resolve every union's first-byte dispatch AFTER the whole
        schema is compiled. During compilation a ``$ref`` target may still
        be a pending node whose first-byte set is unknown — computing
        dispatch eagerly would either over-approximate (spuriously
        rejecting valid disjoint unions like the nullable-recursive
        ``anyOf: [$ref, null]``) or under-constrain. The same traversal
        rejects $ref/anyOf cycles with no intervening construct (e.g.
        ``a = {"$ref": "#/$defs/a"}``), whose dispatch would otherwise
        recurse unboundedly at mask time."""
        memo: Dict[int, Dict[int, int]] = {}

        def first_bytes(nid: int, stack: tuple) -> Dict[int, int]:
            """byte -> the member node to dispatch to (nid itself for
            concrete nodes)."""
            node = self.nodes[nid]
            if node[0] != "union_raw" and node[0] != "union":
                return {b: nid for b in range(256)
                        if _value_first_byte_ok(self, nid, b)}
            if nid in stack:
                raise GuidedUnsupported(
                    "$ref/anyOf cycle with no intervening object or "
                    "array: the schema matches nothing")
            hit = memo.get(nid)
            if hit is not None:
                return hit
            members = (node[1] if node[0] == "union_raw"
                       else tuple(set(node[1].values())))
            dispatch: Dict[int, int] = {}
            for m in members:
                for b, target in first_bytes(m, stack + (nid,)).items():
                    # dispatch one level down: to the member (which may
                    # itself be a finalized union — recursion terminates
                    # because cycles were just rejected)
                    if b in dispatch and dispatch[b] != m:
                        raise GuidedUnsupported(
                            "anyOf/oneOf branches must be distinguishable "
                            f"by their first byte (both accept "
                            f"{bytes([b])!r})")
                    dispatch[b] = m
            memo[nid] = dispatch
            return dispatch

        for i, node in enumerate(self.nodes):
            if node[0] == "union_raw":
                self.nodes[i] = ("union", first_bytes(i, ()))
        if any(n[0] == "pending" for n in self.nodes):
            raise AssertionError("unresolved pending node after compile")

    _IGNORED = frozenset((
        "title", "description", "default", "examples", "$schema", "$id",
        "$defs", "definitions", "additionalProperties", "strict"))
    _KNOWN = frozenset((
        "type", "properties", "required", "items", "enum", "const",
        "anyOf", "oneOf", "$ref")) | _IGNORED

    def _compile(self, s: Dict[str, Any]) -> int:
        if not isinstance(s, dict):
            # JSON Schema allows boolean subschemas ("items": true);
            # raise the designed 400, not a TypeError 500
            raise GuidedUnsupported(
                f"subschemas must be objects, got {s!r}")
        unknown = set(s) - self._KNOWN
        if unknown:
            raise GuidedUnsupported(
                f"unsupported JSON-Schema keywords: {sorted(unknown)}")
        if s.get("additionalProperties") not in (None, False):
            raise GuidedUnsupported(
                "additionalProperties must be false/absent (objects are "
                "generated closed, as OpenAI structured outputs)")
        ref = s.get("$ref")
        if ref is not None:
            if not isinstance(ref, str):
                raise GuidedUnsupported(f"$ref must be a string, got {ref!r}")
            if ref in self._ref_ids:
                return self._ref_ids[ref]
            target = self._defs.get(ref)
            if target is None:
                raise GuidedUnsupported(f"unresolvable $ref {ref!r} "
                                        "(only local #/$defs/... refs)")
            # reserve the id FIRST so recursive schemas terminate; the
            # dispatch is computed in _finalize_unions once `real` exists
            nid = len(self.nodes)
            self.nodes.append(("pending",))
            self._ref_ids[ref] = nid
            real = self._compile(target)
            self.nodes[nid] = ("union_raw", (real,))
            return nid
        if "enum" in s or "const" in s:
            values = s.get("enum", [s.get("const")])
            return self._compile_enum(values)
        if "anyOf" in s or "oneOf" in s:
            return self._compile_union(
                [self._compile(sub) for sub in (s.get("anyOf")
                                                or s.get("oneOf"))])
        t = s.get("type")
        if isinstance(t, list):
            return self._compile_union(
                [self._compile({**s, "type": one}) for one in t])
        if t == "object" or (t is None and "properties" in s):
            if ("properties" not in s and not s.get("required")
                    and s.get("additionalProperties") is None):
                # bare {"type": "object"}: standard JSON-Schema semantics —
                # ANY keys and values (the forced-tool-call envelope's
                # unconstrained `arguments` relies on this). Declaring
                # `properties` (or additionalProperties: false) switches to
                # the CLOSED structured-outputs object.
                return self._push_node(("obj", None, None, frozenset()))
            props_s = s.get("properties") or {}
            req = frozenset(s.get("required") or ())
            missing = req - set(props_s)
            if missing:
                raise GuidedUnsupported(
                    f"required keys absent from properties: {sorted(missing)}")
            nid = len(self.nodes)
            self.nodes.append(("pending",))
            props = {k: self._compile(v) for k, v in props_s.items()}
            # keys are matched in their CANONICAL escaped form (the bytes
            # json.dumps would emit) + the closing quote
            trie = self.add_trie(
                {json.dumps(k)[1:-1].encode() + b'"': k for k in props})
            self.nodes[nid] = ("obj", trie, props, req)
            return nid
        if t == "array":
            nid = len(self.nodes)
            self.nodes.append(("pending",))
            item = self._compile(s["items"]) if "items" in s else self._any()
            self.nodes[nid] = ("arr", item)
            return nid
        if t == "string":
            return self._push_node(("str",))
        if t == "number":
            return self._push_node(("num", False))
        if t == "integer":
            return self._push_node(("num", True))
        if t == "boolean":
            return self._push_node(("bool",))
        if t == "null":
            return self._push_node(("null",))
        if t is None:
            return self._any()
        raise GuidedUnsupported(f"unsupported type {t!r}")

    def _push_node(self, node: Tuple) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def _any(self) -> int:
        return self._push_node(("any",))

    def _compile_enum(self, values: Sequence[Any]) -> int:
        lits: Dict[bytes, Any] = {}
        for v in values:
            if isinstance(v, (dict, list)):
                raise GuidedUnsupported(
                    "enum/const of objects/arrays is not supported")
            lits[json.dumps(v).encode()] = "value"
        trie = self.add_trie(lits)
        return self._push_node(("enum", trie))

    def _compile_union(self, nids: List[int]) -> int:
        # dispatch resolution deferred to _finalize_unions: members may
        # still be pending $ref reservations here
        return self._push_node(("union_raw", tuple(nids)))


def _value_first_byte_ok(g: Grammar, nid: int, b: int) -> bool:
    """Whether byte b can START a value of node nid (no whitespace)."""
    kind = g.nodes[nid]
    head = kind[0]
    if head == "any":
        return b in b'{["-tfn' or b in _DIGITS
    if head == "obj":
        return b == 0x7B                                  # {
    if head == "arr":
        return b == 0x5B                                  # [
    if head == "str":
        return b == 0x22                                  # "
    if head == "num":
        return b == 0x2D or b in _DIGITS                  # - or digit
    if head == "bool":
        return b in b"tf"
    if head == "null":
        return b == 0x6E                                  # n
    if head == "enum":
        return b in g.lit_edges[kind[1]][0]
    if head == "union":
        return b in kind[1]
    raise AssertionError(head)   # pending/union_raw resolve pre-runtime


# --------------------------------------------------------------------------
# the pushdown automaton
#
# Frames (immutable tuples):
#   ("val", nid)                      expect a value of node nid (ws ok)
#   ("str",)                          generic string body (after ")
#   ("esc",)                          after backslash inside a string
#   ("uni", k)                        k hex digits of \uXXXX remain
#   ("lit", trie_id, pos, role)       inside a literal; role "key"/"value"
#   ("num", st, int_only)             st: "-","0","i","f0","f","e0","es","e"
#   ("obj", nid, used, phase, pend)   phase: "first","key","colon","post"
#   ("arr", nid, phase)               phase: "first","post"
#   ("done",)


def initial_state(g: Grammar) -> State:
    return (("val", g.root),)


def _complete_value(g: Grammar, stack: State) -> State:
    """A value just finished; pop into the parent construct."""
    if not stack:
        return DONE
    top = stack[-1]
    if top[0] == "obj":
        _, nid, used, phase, pend = top
        return stack[:-1] + (("obj", nid, used, "post", None),)
    if top[0] == "arr":
        _, nid, phase = top
        return stack[:-1] + (("arr", nid, "post"),)
    raise AssertionError(f"value completed under {top[0]}")


def _obj_key_done(g: Grammar, stack: State,
                  key: Any) -> Optional[State]:
    """A property key (lit trie or generic string) finished: expect ':'.
    A re-used schema key is rejected HERE (at its closing quote) so the
    mask can never steer generation into a continuation-free state."""
    top = stack[-1]
    assert top[0] == "obj"
    _, nid, used, phase, _pend = top
    if key != -1 and key in used:
        return None
    return stack[:-1] + (("obj", nid, used, "colon", key),)


def _any_value_start(g: Grammar, stack: State, b: int,
                     nid: int) -> Optional[State]:
    """Dispatch the first byte of a value; stack excludes the val frame."""
    node = g.nodes[nid]
    head = node[0]
    if head == "union":
        target = node[1].get(b)
        if target is None:
            return None
        return _any_value_start(g, stack, b, target)
    if head == "enum":
        edges = g.lit_edges[node[1]][0]
        nxt = edges.get(b)
        if nxt is None:
            return None
        st = stack + (("lit", node[1], nxt, "value"),)
        return _lit_maybe_end(g, st)
    if b == 0x7B and head in ("any", "obj"):              # {
        if head == "any":
            return stack + (("obj", -1, frozenset(), "first", None),)
        _, trie, props, req = node
        if trie is None:                                  # any_object root
            return stack + (("obj", -1, frozenset(), "first", None),)
        return stack + (("obj", nid, frozenset(), "first", None),)
    if b == 0x5B and head in ("any", "arr"):              # [
        item = node[1] if head == "arr" else -1
        return stack + (("arr", item, "first"),)
    if b == 0x22 and head in ("any", "str"):              # "
        return stack + (("str",),)
    if (b == 0x2D or b in _DIGITS) and head in ("any", "num"):
        int_only = node[1] if head == "num" else False
        st = "-" if b == 0x2D else ("0" if b == 0x30 else "i")
        return stack + (("num", st, int_only, MAX_NUM_LEN - 1),)
    if b == 0x74 and head in ("any", "bool"):             # t
        t_id = _keyword_trie(g, b"rue")
        return stack + (("lit", t_id, 0, "value"),)
    if b == 0x66 and head in ("any", "bool"):             # f
        return stack + (("lit", _keyword_trie(g, b"alse"), 0, "value"),)
    if b == 0x6E and head in ("any", "null"):             # n
        return stack + (("lit", _keyword_trie(g, b"ull"), 0, "value"),)
    return None


def _keyword_trie(g: Grammar, rest: bytes) -> int:
    """Lazily interned tries for the true/false/null keyword tails."""
    cache = getattr(g, "_kw_tries", None)
    if cache is None:
        cache = {}
        g._kw_tries = cache
    tid = cache.get(rest)
    if tid is None:
        tid = g.add_trie({rest: "value"})
        cache[rest] = tid
    return tid


def _lit_maybe_end(g: Grammar, stack: State) -> Optional[State]:
    """If the lit frame on top sits on a terminal trie node with no
    outgoing edges, resolve its completion now (deterministic). Returns
    None when the completion is itself illegal (a re-used object key) —
    the byte that finished the literal is rejected, keeping every
    reachable state continuable."""
    top = stack[-1]
    if top[0] != "lit":
        return stack
    _, tid, pos, role = top
    payload = g.lit_ends[tid].get(pos)
    if payload is None or g.lit_edges[tid][pos]:
        # not terminal, or terminal-with-continuation (a prefix literal
        # with longer alternatives stays un-resolved until a
        # non-matching byte arrives — handled in step())
        return stack
    below = stack[:-1]
    if role == "key":
        return _obj_key_done(g, below, payload)
    return _complete_value(g, below)


_NUM_ACCEPTING = frozenset("0ife")


def _num_done(g: Grammar, stack: State) -> Optional[State]:
    """Pop a completed number (top frame) into its parent."""
    top = stack[-1]
    if top[0] != "num" or top[1] not in _NUM_ACCEPTING:
        return None
    return _complete_value(g, stack[:-1])


def step(g: Grammar, state: State, b: int) -> Optional[State]:
    """Feed one byte; returns the next state or None (rejected)."""
    top = state[-1]
    head = top[0]

    if head == "done":
        return None

    if head == "ws":
        if b in WS:
            k = top[1]
            return state[:-1] + (("ws", k - 1),) if k > 0 else None
        return step(g, state[:-1], b)

    if head == "val":
        if b in WS:
            return state + (("ws", MAX_WS - 1),)
        return _any_value_start(g, state[:-1], b, top[1])

    if head == "str":
        if b == 0x22:                                     # closing "
            below = state[:-1]
            if below and below[-1][0] == "obj" \
                    and below[-1][3] == "first_key":
                return _obj_key_done(g, below, -1)        # never None
            return _complete_value(g, below)
        if b == 0x5C:                                     # backslash
            return state + (("esc",),)
        if b < 0x20:
            return None                                   # raw control char
        if b < 0x80:
            return state
        # multi-byte UTF-8: lead bytes open a continuation frame so the
        # constrained output is always decodable text, even when a
        # byte-level vocabulary splits a character across tokens
        if 0xC2 <= b <= 0xDF:
            return state + (("u8", 1),)
        if 0xE0 <= b <= 0xEF:
            return state + (("u8", 2),)
        if 0xF0 <= b <= 0xF4:
            return state + (("u8", 3),)
        return None           # bare continuation / overlong lead byte

    if head == "u8":
        if 0x80 <= b <= 0xBF:
            k = top[1] - 1
            return state[:-1] if k == 0 else state[:-1] + (("u8", k),)
        return None

    if head == "esc":
        if b not in _ESCAPABLE:
            return None
        if b == 0x75:                                     # u
            return state[:-1] + (("uni", 4),)
        return state[:-1]

    if head == "uni":
        if b not in _HEX:
            return None
        k = top[1] - 1
        return state[:-1] if k == 0 else state[:-1] + (("uni", k),)

    if head == "lit":
        _, tid, pos, role = top
        nxt = g.lit_edges[tid][pos].get(b)
        if nxt is not None:
            if role == "key":
                # prune by reachability: the obj frame sits directly
                # below a key literal; refuse to enter a subtree whose
                # every key is already used
                used = state[-2][2]
                if not (g.lit_reach[tid][nxt] - used):
                    return None
            return _lit_maybe_end(
                g, state[:-1] + (("lit", tid, nxt, role),))
        # no edge: if we are AT a terminal, the literal ended one byte
        # ago — resolve it and reprocess b in the parent context
        payload = g.lit_ends[tid].get(pos)
        if payload is None:
            return None
        below = state[:-1]
        resolved = (_obj_key_done(g, below, payload) if role == "key"
                    else _complete_value(g, below))
        if resolved is None:
            return None
        return step(g, resolved, b)

    if head == "num":
        _, st, int_only, left = top
        if left <= 0 and (b in _DIGITS or b in b".eE+-"):
            # length cap: only a terminator (handled below) may follow
            done = _num_done(g, state)
            return step(g, done, b) if done is not None else None

        def to(st2: str) -> State:
            return state[:-1] + (("num", st2, int_only, left - 1),)

        if st == "-":
            if b == 0x30:
                return to("0")
            if b in _DIGITS:
                return to("i")
            return None
        if st in ("0", "i", "f", "e"):
            if b in _DIGITS:
                if st == "0":
                    return None                           # no leading zeros
                return to(st)
            # '.'/'e' need at least one digit AFTER them within the length
            # cap, or they would open a reachable dead end (an empty mask
            # silently drops the constraint)
            if (b == 0x2E and st in ("0", "i") and not int_only
                    and left >= 2):                       # .
                return to("f0")
            if (b in b"eE" and st in ("0", "i", "f") and not int_only
                    and left >= 2):
                return to("e0")
            done = _num_done(g, state)
            return step(g, done, b) if done is not None else None
        if st == "f0":
            return to("f") if b in _DIGITS else None
        if st == "e0":
            if b in b"+-" and left >= 2:                  # sign needs digit
                return to("es")
            return to("e") if b in _DIGITS else None
        if st == "es":
            return to("e") if b in _DIGITS else None
        raise AssertionError(st)

    if head == "obj":
        _, nid, used, phase, pend = top
        if b in WS:
            return state + (("ws", MAX_WS - 1),)
        open_keys = nid == -1 or g.nodes[nid][1] is None

        def with_phase(phase2, pend2=None, used2=None) -> State:
            return state[:-1] + (
                ("obj", nid, used2 if used2 is not None else used,
                 phase2, pend2),)

        if phase in ("first", "key", "post"):
            if b == 0x7D and phase in ("first", "post"):  # }
                if not open_keys:
                    req = g.nodes[nid][3]
                    if req - used:
                        return None                       # required missing
                return _complete_value(g, state[:-1])
            keys_remain = open_keys or bool(
                set(g.nodes[nid][2]) - used)
            if b == 0x2C and phase == "post":             # ,
                # a comma commits to another key: only legal while unused
                # keys remain, or the state would have no continuation
                return with_phase("key") if keys_remain else None
            if b == 0x22 and phase in ("first", "key"):   # " -> a key
                if open_keys:
                    return with_phase("first_key") + (("str",),)
                if not keys_remain:
                    return None
                trie = g.nodes[nid][1]
                return with_phase("in_key") + (("lit", trie, 0, "key"),)
            return None
        if phase == "colon":
            if b != 0x3A:                                 # :
                return None
            if pend == -1 or open_keys:                   # generic key
                return state[:-1] + (
                    ("obj", nid, used, "inval", None),
                    ("val", _any_nid(g)))
            if pend in used:
                return None                               # duplicate key
            return state[:-1] + (
                ("obj", nid, used | {pend}, "inval", None),
                ("val", g.nodes[nid][2][pend]))
        return None

    if head == "arr":
        _, item, phase = top
        if b in WS:
            return state + (("ws", MAX_WS - 1),)
        if b == 0x5D and phase in ("first", "post"):      # ]
            return _complete_value(g, state[:-1])
        item_nid = item if item != -1 else _any_nid(g)
        if b == 0x2C and phase == "post":                 # ,
            return state[:-1] + (("arr", item, "inval"),
                                 ("val", item_nid))
        if phase == "first":
            # not ']': the byte starts the first element's value
            st = state[:-1] + (("arr", item, "inval"), ("val", item_nid))
            return step(g, st, b)
        return None

    raise AssertionError(head)


def _any_nid(g: Grammar) -> int:
    """Interned ("any",) node id for open objects/arrays."""
    nid = getattr(g, "_any_id", None)
    if nid is None:
        for i, n in enumerate(g.nodes):
            if n == ("any",):
                nid = i
                break
        else:
            nid = g._push_node(("any",))
        g._any_id = nid
    return nid


def eos_ok(g: Grammar, state: State) -> bool:
    """EOS is legal when the document is complete — including a root-level
    number or literal whose end is only implied by the end of output (a
    prefix enum literal like 1 in ``enum [1, 12]`` sits on a terminal trie
    node that still has edges; EOS must resolve it the way a terminator
    byte would, or the shorter value is unreachable)."""
    if state == DONE or state[-1][0] == "done":
        return True
    done = _num_done(g, state)
    if done is not None and done[-1][0] == "done":
        return True
    top = state[-1]
    if top[0] == "lit" and top[3] == "value":
        payload = g.lit_ends[top[1]].get(top[2])
        if payload is not None:
            resolved = _complete_value(g, state[:-1])
            return resolved[-1][0] == "done"
    return False


# --------------------------------------------------------------------------
# vocabulary trie + masks


class TokenTrie:
    """Byte trie over the vocabulary for mask computation.

    ``None`` byte entries (special tokens) are excluded from every mask —
    only EOS ids are handled separately by eos_ok.
    """

    __slots__ = ("root", "vocab_size")

    def __init__(self, token_bytes: Sequence[Optional[bytes]]):
        self.vocab_size = len(token_bytes)
        # node = [children: {byte: node}, ids: list of token ids ending here]
        self.root: list = [{}, []]
        for tid, bs in enumerate(token_bytes):
            if bs is None or len(bs) == 0:
                continue
            node = self.root
            for b in bs:
                nxt = node[0].get(b)
                if nxt is None:
                    nxt = [{}, []]
                    node[0][b] = nxt
                node = nxt
            node[1].append(tid)


def _classify_string_token(bs: bytes) -> str:
    """How a token behaves from a CLEAN string-body state, independent of
    everything below the string frame:

    - "interior": stays inside the string machinery (may end mid-escape
      or mid-UTF-8) — allowed in EVERY clean string-body state
    - "closing":  reaches an unescaped '"' — verdict depends on the stack
      below (what may follow the closed string), needs a real walk
    - "reject":   hits a control byte / invalid UTF-8 first — allowed in
      NO string-body state
    """
    esc = False
    uni = 0
    u8 = 0
    for b in bs:
        if u8:
            if 0x80 <= b <= 0xBF:
                u8 -= 1
                continue
            return "reject"
        if uni:
            if b not in _HEX:
                return "reject"
            uni -= 1
            continue
        if esc:
            if b not in _ESCAPABLE:
                return "reject"
            esc = False
            if b == 0x75:                                 # u
                uni = 4
            continue
        if b == 0x22:
            return "closing"
        if b == 0x5C:
            esc = True
            continue
        if b < 0x20:
            return "reject"
        if b < 0x80:
            continue
        if 0xC2 <= b <= 0xDF:
            u8 = 1
        elif 0xE0 <= b <= 0xEF:
            u8 = 2
        elif 0xF0 <= b <= 0xF4:
            u8 = 3
        else:
            return "reject"
    return "interior"


class GuidedVocab:
    """Vocabulary-side state shared by every guided request of a model.

    String-body states are the expensive ones (nearly the whole trie
    survives the walk), so the vocabulary is pre-partitioned once: tokens
    that stay INSIDE the string machinery get a precomputed always-on
    mask, and only the small quote-touching subset walks per state —
    measured ~20× faster cold masks at a 32k vocab."""

    def __init__(self, token_bytes: Sequence[Optional[bytes]],
                 eos_ids: Sequence[int], mask_cache: int = 256):
        self.trie = TokenTrie(token_bytes)
        self.eos_ids = [e for e in eos_ids if 0 <= e < self.trie.vocab_size]
        self.words = -(-self.trie.vocab_size // 32)
        self._cache: Dict[Tuple["Grammar", State], np.ndarray] = {}
        self._cache_cap = mask_cache
        self.str_interior = np.zeros(self.words, np.uint32)
        closing: List[Optional[bytes]] = [None] * len(token_bytes)
        for tid, bs in enumerate(token_bytes):
            if bs is None or len(bs) == 0:
                continue
            kind = _classify_string_token(bs)
            if kind == "interior":
                self.str_interior[tid >> 5] |= np.uint32(1 << (tid & 31))
            elif kind == "closing":
                closing[tid] = bs
        self.str_closing_trie = TokenTrie(closing)

    def mask(self, g: Grammar, state: State) -> np.ndarray:
        """Packed uint32 allow-mask [words] for this automaton state.

        The cache key holds the Grammar STRONGLY (object identity hash):
        an id()-based key would serve a freed grammar's masks to a new
        grammar reusing the same address."""
        key = (g, state)
        hit = self._cache.get(key)
        if hit is not None:
            return hit

        def walk(node, st: State) -> None:
            for tid in node[1]:
                out[tid >> 5] |= np.uint32(1 << (tid & 31))
            for b, child in node[0].items():
                st2 = step(g, st, b)
                if st2 is not None:
                    walk(child, st2)

        if state[-1] == ("str",):
            # clean string body: interior tokens are allowed regardless of
            # the stack below; only quote-touching tokens need stepping
            out = self.str_interior.copy()
            root = self.str_closing_trie.root
        else:
            out = np.zeros(self.words, np.uint32)
            root = self.trie.root
        # token ids reachable by stepping their bytes from `state`
        for b, child in root[0].items():
            st2 = step(g, state, b)
            if st2 is not None:
                walk(child, st2)
        if eos_ok(g, state):
            for e in self.eos_ids:
                out[e >> 5] |= np.uint32(1 << (e & 31))
        if len(self._cache) >= self._cache_cap:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = out
        return out


class GuidedRequest:
    """Per-request automaton state, advanced lazily from generated ids."""

    __slots__ = ("grammar", "state", "n_seen", "vocab", "token_bytes",
                 "wedged", "last_step")

    def __init__(self, grammar: Grammar, vocab: GuidedVocab,
                 token_bytes: Sequence[Optional[bytes]]):
        self.grammar = grammar
        self.vocab = vocab
        self.token_bytes = token_bytes
        self.state = initial_state(grammar)
        self.n_seen = 0
        self.wedged = False
        self.last_step = 0  # engine step of last use (eviction ordering)

    def catch_up(self, generated: Sequence[int]) -> None:
        for tid in generated[self.n_seen:]:
            self.advance(tid)
        self.n_seen = len(generated)

    def advance(self, token_id: int) -> None:
        if self.wedged:
            return
        if token_id in self.vocab.eos_ids:
            return
        bs = self.token_bytes[token_id] if token_id < len(
            self.token_bytes) else None
        if bs is None:
            self.wedged = True                            # special slipped in
            return
        st = self.state
        for b in bs:
            st2 = step(self.grammar, st, b)
            if st2 is None:
                # a token outside the mask was forced (e.g. a replayed
                # request); stop constraining rather than mask everything
                self.wedged = True
                return
            st = st2
        self.state = st

    def mask(self) -> Optional[np.ndarray]:
        if self.wedged:
            return None
        m = self.vocab.mask(self.grammar, self.state)
        if not m.any():
            # a continuation-free state would turn every logit to -inf and
            # sample NaN; the automaton is designed dead-end free, but if a
            # bug (or a vocabulary that simply cannot spell the required
            # literal) gets here, dropping the constraint beats poisoning
            # the batch
            self.wedged = True
            return None
        return m


# --------------------------------------------------------------------------
# dense device table (fused multistep decoding)


class GuidedTable:
    """A grammar lowered to a dense token-granularity transition table.

    The fused multistep block cannot call back into the host automaton
    between scan steps, so a grammar whose TOKEN-level state machine is
    small enough is compiled down to two arrays the device can index:

    trans: [S, V] int32 — ``trans[s, t]`` is the state after sampling
           token ``t`` in state ``s``. Disallowed tokens self-loop (the
           mask makes them unsampleable, the entry is never read live);
           EOS ids self-loop too, mirroring ``GuidedRequest.advance``'s
           EOS no-op.
    masks: [S, words] uint32 — packed allow-mask per state, bit-identical
           to ``GuidedVocab.mask`` for the same automaton state (the
           per-step path and the fused path must reject exactly the same
           tokens or parity breaks).

    State 0 is always the grammar's initial state. The engine batches
    tables by concatenating them at offsets behind a shared all-ones
    sentinel row, so unconstrained rows ride the same gather.
    """

    __slots__ = ("trans", "masks")

    def __init__(self, trans: np.ndarray, masks: np.ndarray):
        self.trans = trans
        self.masks = masks

    @property
    def nbytes(self) -> int:
        return self.trans.nbytes + self.masks.nbytes

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]


def build_guided_table(g: Grammar, vocab: GuidedVocab,
                       byte_cap: int) -> Optional[GuidedTable]:
    """BFS the token-granularity state machine of ``g`` into a dense table.

    Each automaton state costs one trie walk: the byte-automaton state at
    the trie node where a token's bytes end IS the post-token state (the
    walk resolves literal completions inline exactly as ``step`` does), so
    allowed tokens and their successor states come out of the same pass
    that ``GuidedVocab.mask`` uses — no per-token byte replay.

    Returns ``None`` when the grammar is not tableable:

    - the state count would exceed ``byte_cap`` worth of table (open-ended
      grammars like ``{"mode": "json"}`` nest unboundedly and always trip
      this) — the scheduler then falls back per-row with reason
      ``guided_table``;
    - some reachable state has an empty allow-mask (the per-step path
      wedges and drops the constraint there; a device table has no wedge,
      so such grammars stay on the host path).
    """
    V = vocab.trie.vocab_size
    words = vocab.words
    s_max = max(1, byte_cap // (4 * V + 4 * words))
    init = initial_state(g)
    ids: Dict[State, int] = {init: 0}
    order: List[State] = [init]
    trans_rows: List[np.ndarray] = []
    mask_rows: List[np.ndarray] = []

    sid = 0
    while sid < len(order):
        state = order[sid]
        row = np.full(V, sid, np.int32)
        mask = np.zeros(words, np.uint32)

        def intern(st: State) -> int:
            nid = ids.get(st)
            if nid is None:
                nid = len(order)
                ids[st] = nid
                order.append(st)
            return nid

        def walk(node, st: State) -> None:
            for tid in node[1]:
                mask[tid >> 5] |= np.uint32(1 << (tid & 31))
                row[tid] = intern(st)
            for b, child in node[0].items():
                st2 = step(g, st, b)
                if st2 is not None:
                    walk(child, st2)

        for b, child in vocab.trie.root[0].items():
            st2 = step(g, state, b)
            if st2 is not None:
                walk(child, st2)
        if eos_ok(g, state):
            for e in vocab.eos_ids:
                mask[e >> 5] |= np.uint32(1 << (e & 31))
        if not mask.any():
            return None
        if len(order) > s_max:
            return None
        trans_rows.append(row)
        mask_rows.append(mask)
        sid += 1
    return GuidedTable(np.stack(trans_rows), np.stack(mask_rows))


# --------------------------------------------------------------------------
# grammar construction / cache


def compile_guided(spec: Dict[str, Any]) -> Grammar:
    """spec = {"mode": "json"} or {"mode": "json_schema", "schema": {...}}"""
    mode = spec.get("mode")
    if mode == "json":
        return Grammar.any_object()
    if mode == "json_schema":
        return Grammar.from_schema(spec.get("schema") or {})
    raise GuidedUnsupported(f"unknown guided mode {mode!r}")


__all__ = ["Grammar", "GuidedVocab", "GuidedRequest", "GuidedUnsupported",
           "GuidedTable", "build_guided_table", "TokenTrie",
           "compile_guided", "initial_state", "step", "eos_ok"]
