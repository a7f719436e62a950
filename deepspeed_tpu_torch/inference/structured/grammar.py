"""Grammar / JSON-schema → token-level DFA compiler.

Constrained decoding needs, per (schema, vocabulary) pair, a transition
table over TOKEN ids: from DFA state ``s``, emitting token ``t`` either
moves to ``trans[s, t]`` or is forbidden (``mask[s, t] == False``). The
compile pipeline:

1. a JSON-schema subset lowers to a regular expression
   (:func:`json_schema_to_regex`) — or callers pass a regex directly;
2. the regex compiles to a CHARACTER DFA by Brzozowski derivatives
   (no NFA construction, states are the regex's derivative classes —
   small and canonical for the schema-shaped languages this serves);
3. every vocab token's string is run through the char DFA from every
   state, producing the token-level ``trans``/``mask`` tables
   (:class:`CompiledSchema`) the engine uploads as device slabs.

EOS handling: when ``eos_token_id`` is given, EOS is allowed exactly in
ACCEPTING states (so generation can only stop on a schema-complete
output, and a state with no other legal continuation forces EOS).
Compile-time dead-end check: every reachable state must allow at least
one token, otherwise the device-side mask would zero a whole softmax
row mid-stream — that schema/vocab pair is rejected here, typed, at
submit time (:class:`SchemaCompileError`), never on the pump thread.

Precompiled tables are cached per (schema hash, vocab signature) in the
process-wide :class:`store.SchemaCompilerCache`.

Port: a copy of ``deepspeed_tpu/inference/structured/grammar.py``,
which is pure numpy, hashlib and json.
"""

import hashlib
import json

import numpy as np

# the char alphabet: printable ASCII. Schema-shaped languages (JSON)
# live entirely inside it; vocab tokens containing other bytes simply
# have no transitions (masked everywhere).
_ALPHABET = frozenset(chr(c) for c in range(32, 127))

# regex AST: ("eps",) | ("null",) | ("chr", frozenset) |
#            ("cat", a, b) | ("alt", a, b) | ("star", a)
_EPS = ("eps",)
_NULL = ("null",)


class SchemaCompileError(ValueError):
    """Typed compile-time rejection: malformed regex/schema, an
    unsupported JSON-schema construct, or a schema whose token DFA has
    a reachable dead-end state (no legal next token) for this vocab.

    Registered in the fleet's wire-error registry: a remote submit with
    a bad schema raises this on the worker and must decode as the SAME
    type on the client — and never be retried on another replica, since
    a schema that fails to compile here fails everywhere."""

    reason = "schema_compile"
    retry_elsewhere = False


# ------------------------------------------------- smart constructors
def _chr(chars):
    return ("chr", frozenset(chars)) if chars else _NULL


def _cat(a, b):
    if a == _NULL or b == _NULL:
        return _NULL
    if a == _EPS:
        return b
    if b == _EPS:
        return a
    return ("cat", a, b)


def _alt(a, b):
    if a == _NULL:
        return b
    if b == _NULL:
        return a
    if a == b:
        return a
    # canonical operand order so derivative states dedup
    return ("alt",) + tuple(sorted((a, b), key=repr))


def _star(a):
    if a in (_NULL, _EPS):
        return _EPS
    if a[0] == "star":
        return a
    return ("star", a)


def _nullable(r):
    t = r[0]
    if t == "eps" or t == "star":
        return True
    if t == "null" or t == "chr":
        return False
    if t == "cat":
        return _nullable(r[1]) and _nullable(r[2])
    return _nullable(r[1]) or _nullable(r[2])  # alt


def _deriv(r, c):
    """Brzozowski derivative of regex ``r`` w.r.t. char ``c``."""
    t = r[0]
    if t == "eps" or t == "null":
        return _NULL
    if t == "chr":
        return _EPS if c in r[1] else _NULL
    if t == "cat":
        d = _cat(_deriv(r[1], c), r[2])
        if _nullable(r[1]):
            d = _alt(d, _deriv(r[2], c))
        return d
    if t == "alt":
        return _alt(_deriv(r[1], c), _deriv(r[2], c))
    return _cat(_deriv(r[1], c), r)  # star


# --------------------------------------------------------- regex parser
_CLASS_ESCAPES = {
    "d": "0123456789",
    "w": "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_",
    "s": " \t",
}


class _Parser:
    """Recursive-descent parser for the supported dialect: literals,
    ``\\``-escapes (incl. ``\\d``/``\\w``/``\\s``), ``.``, ``[...]``
    classes with ranges and ``^`` negation, grouping ``( )``,
    alternation ``|``, and the quantifiers ``* + ? {m} {m,n}``
    (bounded repeats expand at parse time — the DFA stays finite)."""

    def __init__(self, pattern):
        self.s = pattern
        self.i = 0

    def fail(self, msg):
        raise SchemaCompileError(
            f"regex error at offset {self.i} in {self.s!r}: {msg}")

    def peek(self):
        return self.s[self.i] if self.i < len(self.s) else None

    def eat(self):
        c = self.peek()
        if c is None:
            self.fail("unexpected end of pattern")
        self.i += 1
        return c

    def parse(self):
        r = self.alt()
        if self.i != len(self.s):
            self.fail(f"unbalanced {self.peek()!r}")
        return r

    def alt(self):
        r = self.concat()
        while self.peek() == "|":
            self.eat()
            r = _alt(r, self.concat())
        return r

    def concat(self):
        r = _EPS
        while self.peek() not in (None, "|", ")"):
            r = _cat(r, self.repeat())
        return r

    def repeat(self):
        r = self.atom()
        while self.peek() in ("*", "+", "?", "{"):
            op = self.eat()
            if op == "*":
                r = _star(r)
            elif op == "+":
                r = _cat(r, _star(r))
            elif op == "?":
                r = _alt(r, _EPS)
            else:  # {m} / {m,n}
                m = self._int()
                n = m
                if self.peek() == ",":
                    self.eat()
                    n = self._int()
                if self.eat() != "}":
                    self.fail("expected '}'")
                if n < m:
                    self.fail(f"bad repeat bounds {{{m},{n}}}")
                out = _EPS
                for _ in range(m):
                    out = _cat(out, r)
                opt = _alt(r, _EPS)
                for _ in range(n - m):
                    out = _cat(out, opt)
                r = out
        return r

    def _int(self):
        digits = ""
        while self.peek() is not None and self.peek().isdigit():
            digits += self.eat()
        if not digits:
            self.fail("expected integer")
        return int(digits)

    def atom(self):
        c = self.eat()
        if c == "(":
            r = self.alt()
            if self.eat() != ")":
                self.fail("expected ')'")
            return r
        if c == "[":
            return _chr(self._char_class())
        if c == ".":
            return _chr(_ALPHABET)
        if c == "\\":
            return _chr(self._escape())
        if c in ("*", "+", "?", "{", ")"):
            self.fail(f"dangling {c!r}")
        return _chr({c})

    def _escape(self):
        e = self.eat()
        if e in _CLASS_ESCAPES:
            return set(_CLASS_ESCAPES[e])
        if e == "n":
            return {"\n"}
        if e == "t":
            return {"\t"}
        return {e}  # \\ \. \{ \" etc: the literal char

    def _char_class(self):
        negate = False
        if self.peek() == "^":
            self.eat()
            negate = True
        chars = set()
        while True:
            c = self.peek()
            if c is None:
                self.fail("unterminated character class")
            if c == "]" and chars:
                self.eat()
                break
            c = self.eat()
            if c == "\\":
                chars |= self._escape()
                continue
            if self.peek() == "-" and self.i + 1 < len(self.s) \
                    and self.s[self.i + 1] != "]":
                self.eat()  # '-'
                hi = self.eat()
                if hi == "\\":
                    hi = self.eat()
                if ord(hi) < ord(c):
                    self.fail(f"bad range {c}-{hi}")
                chars |= {chr(x) for x in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        if negate:
            chars = set(_ALPHABET) - chars
        return chars


def _char_dfa(pattern):
    """regex → (transitions {state: {char: state}}, accepting set,
    n_states); state 0 is the start. States are derivative classes,
    discovered by BFS; the dead regex (NULL) is NOT a state — a char
    whose derivative is NULL simply has no transition."""
    start = _Parser(pattern).parse()
    if start == _NULL:
        raise SchemaCompileError(f"regex {pattern!r} matches nothing")
    ids = {start: 0}
    order = [start]
    trans = {}
    frontier = [start]
    while frontier:
        r = frontier.pop()
        row = {}
        # group alphabet chars by derivative so each class derives once
        for c in sorted(_ALPHABET):
            d = _deriv(r, c)
            if d == _NULL:
                continue
            if d not in ids:
                if len(ids) >= 4096:
                    raise SchemaCompileError(
                        f"regex {pattern!r} exceeds 4096 DFA states")
                ids[d] = len(ids)
                order.append(d)
                frontier.append(d)
            row[c] = ids[d]
        trans[ids[r]] = row
    accepting = {ids[r] for r in order if _nullable(r)}
    return trans, accepting, len(ids)


# ------------------------------------------------ JSON-schema lowering
def _regex_escape(s):
    out = []
    for c in s:
        if c in r"\.[]{}()*+?|^$-":
            out.append("\\" + c)
        else:
            out.append(c)
    return "".join(out)


# the constrained string charset: no quote, no backslash (escape-free
# strings keep the char DFA a few states instead of hundreds)
_STRING_BODY = r'[a-zA-Z0-9_\-. ]*'


def json_schema_to_regex(schema):
    """Lower a JSON-schema SUBSET to a regex over the emitted text:
    ``object`` (all declared properties required, declaration order),
    ``array`` (``minItems``/``maxItems``, default 0..3), ``string``
    (restricted escape-free charset), ``integer``, ``number``,
    ``boolean``, ``null``, ``enum`` of JSON scalars, and ``const``.
    Anything else raises :class:`SchemaCompileError` — silently
    accepting an unsupported keyword would emit schema-violating text
    while claiming it is constrained."""
    if isinstance(schema, str):
        return schema  # already a regex
    if not isinstance(schema, dict):
        raise SchemaCompileError(f"schema must be a dict or regex string, "
                                 f"got {type(schema).__name__}")
    if "enum" in schema:
        opts = "|".join(_regex_escape(json.dumps(v)) for v in schema["enum"])
        return f"({opts})"
    if "const" in schema:
        return _regex_escape(json.dumps(schema["const"]))
    t = schema.get("type")
    if t == "string":
        return f'"{_STRING_BODY}"'
    if t == "integer":
        return "(0|-?[1-9][0-9]*)"
    if t == "number":
        return r"(0|-?[1-9][0-9]*)(\.[0-9]+)?"
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = json_schema_to_regex(schema.get("items", {"type": "integer"}))
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 3))
        if not 0 <= lo <= hi:
            raise SchemaCompileError(f"bad array bounds [{lo}, {hi}]")
        if hi == 0:
            return r"\[\]"
        body = f"{item}(,{item}){{{max(lo - 1, 0)},{hi - 1}}}"
        return rf"\[({body})\]" if lo > 0 else rf"\[({body})?\]"
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            return r"\{\}"
        pairs = [f'"{_regex_escape(str(k))}":{json_schema_to_regex(v)}'
                 for k, v in props.items()]
        return r"\{" + ",".join(pairs) + r"\}"
    raise SchemaCompileError(
        f"unsupported JSON-schema construct: {schema!r} (supported: "
        f"object/array/string/integer/number/boolean/null/enum/const)")


# -------------------------------------------------------- token tables
def schema_fingerprint(schema):
    """Stable content hash of a raw schema (dict or regex string) —
    the compiler-cache key half that identifies WHAT to generate."""
    canon = json.dumps(schema, sort_keys=True) if isinstance(schema, dict) \
        else schema
    return hashlib.sha256(canon.encode()).hexdigest()


def vocab_signature(token_strings, eos_token_id=None):
    """Stable content hash of a tokenizer surface — the cache-key half
    that identifies what the tables are generated OVER."""
    h = hashlib.sha256()
    for s in token_strings:
        h.update(s.encode())
        h.update(b"\x00")
    h.update(str(eos_token_id).encode())
    return h.hexdigest()


class CompiledSchema:
    """One (schema, vocab) pair's token-level DFA.

    ``trans`` int32 ``[n_states, vocab]`` and ``mask`` bool
    ``[n_states, vocab]``: from state ``s``, token ``t`` is legal iff
    ``mask[s, t]``, and emitting it moves to ``trans[s, t]``
    (disallowed entries hold 0 — never followed, the mask gates them).
    Host-side :meth:`advance`/:meth:`accepting` mirror the device
    gather; the scheduler replays ACCEPTED tokens through them so the
    authoritative DFA state survives bursts, EOS truncation, and
    rewinds without any device readback."""

    def __init__(self, schema, token_strings, eos_token_id=None):
        pattern = json_schema_to_regex(schema)
        char_trans, accepting, n_states = _char_dfa(pattern)
        V = len(token_strings)
        trans = np.zeros((n_states, V), np.int32)
        mask = np.zeros((n_states, V), bool)
        # memoized char-DFA walk: many tokens share strings/prefixes
        walk_cache = {}

        def walk(state, s):
            key = (state, s)
            hit = walk_cache.get(key)
            if hit is not None:
                return hit
            cur = state
            for c in s:
                row = char_trans.get(cur)
                cur = None if row is None else row.get(c)
                if cur is None:
                    break
            walk_cache[key] = cur
            return cur

        for t, s in enumerate(token_strings):
            if not s:
                continue  # empty tokens make no progress: masked (livelock)
            for st in range(n_states):
                nxt = walk(st, s)
                if nxt is not None:
                    trans[st, t] = nxt
                    mask[st, t] = True
        if eos_token_id is not None:
            eos = int(eos_token_id)
            if not 0 <= eos < V:
                raise SchemaCompileError(
                    f"eos_token_id {eos} outside vocab of {V}")
            # EOS is a control token, never content: clear whatever the
            # char walk gave its column before granting it in accepting
            # states only
            mask[:, eos] = False
            trans[:, eos] = 0
            for st in accepting:
                mask[st, eos] = True
                trans[st, eos] = st  # absorbing: post-EOS rows stay legal
        # dead-end check: every reachable state must allow SOMETHING,
        # or the device mask would zero a whole softmax row mid-stream
        reachable = {0}
        frontier = [0]
        while frontier:
            st = frontier.pop()
            for nxt in set(trans[st, mask[st]].tolist()):
                if nxt not in reachable:
                    reachable.add(nxt)
                    frontier.append(nxt)
        dead = [st for st in sorted(reachable) if not mask[st].any()]
        if dead:
            raise SchemaCompileError(
                f"schema compiles to a token DFA with dead-end state(s) "
                f"{dead[:4]} for this vocab — no token (or EOS) can "
                f"legally follow; widen the schema or fix the vocab")
        self.trans = trans
        self.mask = mask
        self.n_states = n_states
        self.start = 0
        self.accepting = frozenset(accepting)
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)
        self.pattern = pattern
        self.schema = schema  # raw source (dict or regex) — trace replay
        self.key = (schema_fingerprint(schema),
                    vocab_signature(token_strings, eos_token_id))

    def advance(self, state, token):
        """Host twin of the in-scan transition: → next state. Raises on
        a masked token — an accepted token that violates its own mask
        means the device and host DFA views diverged (a real bug, never
        a user error)."""
        if not self.mask[state, token]:
            raise SchemaCompileError(
                f"token {token} is not legal from DFA state {state} "
                f"(pattern {self.pattern!r})")
        return int(self.trans[state, token])

    def is_accepting(self, state):
        return int(state) in self.accepting

    def matches(self, text):
        """Host acceptance test over a raw string (test/debug aid)."""
        char_trans, accepting, _ = _char_dfa(self.pattern)
        cur = 0
        for c in text:
            row = char_trans.get(cur)
            cur = None if row is None else row.get(c)
            if cur is None:
                return False
        return cur in accepting


# ---------------------------------------------------- synthetic vocab
def byte_vocab(vocab_size):
    """Deterministic synthetic tokenizer surface for tests/bench (the
    repo carries no real tokenizer): token id ``t`` detokenizes to the
    single printable char ``chr(32 + t % 95)``, cycling so every char
    is reachable from any vocab size >= 95."""
    return [chr(32 + t % 95) for t in range(int(vocab_size))]


def detokenize(token_ids, token_strings):
    """Join token ids back into text through a token-string table."""
    return "".join(token_strings[int(t)] for t in token_ids)
