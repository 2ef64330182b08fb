"""The port's own copy of `llmlb_tpu/structured/regex_dfa.py`.

Regex → character-level DFA, the middle stage of the constraint pipeline.

Grammar-constrained decoding needs a machine it can ask two questions of,
hundreds of thousands of times during table construction and once per sampled
token at serving time: "from state S, does character C keep the match alive,
and where does it land?" A backtracking engine (Python's `re`) cannot answer
per-state questions, so this module implements the classic pipeline directly:

    pattern text → AST → Thompson NFA → subset-construction DFA
                 → dead-state pruning (every surviving state can still accept)

The supported syntax is the subset the JSON-Schema compiler emits plus what
user `pattern` keywords commonly need: literals, `.`, escapes (`\\d \\w \\s
\\n \\r \\t \\f \\xHH \\uHHHH` and escaped metacharacters), character classes
with ranges and negation, grouping (`(...)` / `(?:...)`), alternation, and the
quantifiers `* + ? {m} {m,} {m,n}` (bounded repeats are expanded, so `n` is
capped — see MAX_BOUNDED_REPEAT). Transitions are stored per disjoint
codepoint segment, not per character, so classes like `[^"\\\\]` cost one
entry rather than a million.
"""

from __future__ import annotations

import dataclasses
from bisect import bisect_right

MAX_CODEPOINT = 0x10FFFF
# {m,n} expands to n concatenated copies; a huge bound would explode the NFA.
# 256 covers every repeat the schema compiler emits (maxLength is capped to
# the same figure) while keeping worst-case construction well under a second.
MAX_BOUNDED_REPEAT = 256


class RegexSyntaxError(ValueError):
    """The pattern uses syntax outside the supported subset."""


# ------------------------------------------------------------------ char sets


def _normalize(ranges: list[tuple[int, int]]) -> tuple[tuple[int, int], ...]:
    out: list[tuple[int, int]] = []
    for lo, hi in sorted(r for r in ranges if r[0] <= r[1]):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def _negate(ranges: tuple[tuple[int, int], ...]) -> tuple[tuple[int, int], ...]:
    out = []
    prev = 0
    for lo, hi in ranges:
        if lo > prev:
            out.append((prev, lo - 1))
        prev = hi + 1
    if prev <= MAX_CODEPOINT:
        out.append((prev, MAX_CODEPOINT))
    return tuple(out)


_DIGIT = ((48, 57),)
_WORD = _normalize([(48, 57), (65, 90), (95, 95), (97, 122)])
_SPACE = _normalize([(9, 13), (32, 32)])
_ANY = ((0, MAX_CODEPOINT),)


# ------------------------------------------------------------------------ AST


@dataclasses.dataclass(frozen=True)
class _Chars:
    ranges: tuple[tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class _Concat:
    parts: tuple


@dataclasses.dataclass(frozen=True)
class _Alt:
    options: tuple


@dataclasses.dataclass(frozen=True)
class _Repeat:
    node: object
    min: int
    max: int | None  # None = unbounded


class _Parser:
    def __init__(self, pattern: str):
        self.src = pattern
        self.pos = 0

    def error(self, msg: str) -> RegexSyntaxError:
        return RegexSyntaxError(
            f"{msg} at position {self.pos} in pattern {self.src!r}"
        )

    def peek(self) -> str | None:
        return self.src[self.pos] if self.pos < len(self.src) else None

    def take(self) -> str:
        ch = self.peek()
        if ch is None:
            raise self.error("unexpected end of pattern")
        self.pos += 1
        return ch

    def parse(self):
        node = self.alt()
        if self.pos != len(self.src):
            raise self.error(f"unexpected {self.src[self.pos]!r}")
        return node

    def alt(self):
        options = [self.concat()]
        while self.peek() == "|":
            self.take()
            options.append(self.concat())
        return options[0] if len(options) == 1 else _Alt(tuple(options))

    def concat(self):
        parts = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self.repeat())
        if len(parts) == 1:
            return parts[0]
        return _Concat(tuple(parts))

    def repeat(self):
        node = self.atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.take()
                node = _Repeat(node, 0, None)
            elif ch == "+":
                self.take()
                node = _Repeat(node, 1, None)
            elif ch == "?":
                self.take()
                node = _Repeat(node, 0, 1)
            elif ch == "{":
                node = self.braces(node)
            else:
                return node

    def braces(self, node):
        start = self.pos
        self.take()  # "{"
        body = ""
        while self.peek() not in (None, "}"):
            body += self.take()
        if self.peek() != "}":
            raise self.error("unterminated {...} quantifier")
        self.take()
        try:
            if "," not in body:
                lo = hi = int(body)
            else:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s.strip() else None
        except ValueError:
            self.pos = start
            raise self.error(f"malformed quantifier {{{body}}}") from None
        if lo < 0 or (hi is not None and hi < lo):
            self.pos = start
            raise self.error(f"invalid quantifier bounds {{{body}}}")
        if max(lo, hi or 0) > MAX_BOUNDED_REPEAT:
            self.pos = start
            raise self.error(
                f"quantifier bound over {MAX_BOUNDED_REPEAT} in {{{body}}}"
            )
        return _Repeat(node, lo, hi)

    def atom(self):
        ch = self.take()
        if ch == "(":
            if self.peek() == "?":
                self.take()
                if self.peek() != ":":
                    raise self.error("only (?:...) groups are supported")
                self.take()
            node = self.alt()
            if self.peek() != ")":
                raise self.error("unterminated group")
            self.take()
            return node
        if ch == "[":
            return self.char_class()
        if ch == ".":
            return _Chars(_ANY)
        if ch == "\\":
            return _Chars(self.escape(in_class=False))
        if ch in "*+?{":
            raise self.error(f"quantifier {ch!r} with nothing to repeat")
        if ch in ")]":
            raise self.error(f"unmatched {ch!r}")
        if ch in "^$":
            raise self.error(
                f"anchor {ch!r} is not supported (patterns are full-match)"
            )
        return _Chars(((ord(ch), ord(ch)),))

    def escape(self, in_class: bool) -> tuple[tuple[int, int], ...]:
        ch = self.take()
        if ch == "d":
            return _DIGIT
        if ch == "D":
            return _negate(_DIGIT)
        if ch == "w":
            return _WORD
        if ch == "W":
            return _negate(_WORD)
        if ch == "s":
            return _SPACE
        if ch == "S":
            return _negate(_SPACE)
        simple = {"n": 10, "r": 13, "t": 9, "f": 12, "v": 11, "0": 0,
                  "a": 7, "b": 8 if in_class else None, "e": 27}
        if ch in simple and simple[ch] is not None:
            cp = simple[ch]
            return ((cp, cp),)
        if ch in ("x", "u"):
            width = 2 if ch == "x" else 4
            digits = self.src[self.pos : self.pos + width]
            if len(digits) != width:
                raise self.error(f"truncated \\{ch} escape")
            try:
                cp = int(digits, 16)
            except ValueError:
                raise self.error(f"malformed \\{ch} escape") from None
            self.pos += width
            return ((cp, cp),)
        if ch.isalnum():
            raise self.error(f"unsupported escape \\{ch}")
        return ((ord(ch), ord(ch)),)  # escaped metacharacter, literal

    def char_class(self):
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        ranges: list[tuple[int, int]] = []
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise self.error("unterminated character class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            if ch == "\\":
                self.take()
                sub = self.escape(in_class=True)
                if len(sub) > 1 or sub[0][0] != sub[0][1]:
                    ranges.extend(sub)  # \d-style class escape; no ranges off it
                    continue
                lo = sub[0][0]
            else:
                lo = ord(self.take())
            if self.peek() == "-" and self.src[self.pos + 1 : self.pos + 2] not in ("", "]"):
                self.take()
                if self.peek() == "\\":
                    self.take()
                    sub = self.escape(in_class=True)
                    if len(sub) != 1 or sub[0][0] != sub[0][1]:
                        raise self.error("class escape cannot end a range")
                    hi = sub[0][0]
                else:
                    hi = ord(self.take())
                if hi < lo:
                    raise self.error("reversed character-class range")
                ranges.append((lo, hi))
            else:
                ranges.append((lo, lo))
        norm = _normalize(ranges)
        return _Chars(_negate(norm) if negated else norm)


# ------------------------------------------------------------------------ NFA


class _Nfa:
    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[tuple[tuple[int, int], ...], int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


def _build_nfa(node, nfa: _Nfa) -> tuple[int, int]:
    """Thompson construction: returns (start, accept) fragment states."""
    if isinstance(node, _Chars):
        s, a = nfa.state(), nfa.state()
        nfa.edges[s].append((node.ranges, a))
        return s, a
    if isinstance(node, _Concat):
        if not node.parts:
            s = nfa.state()
            return s, s
        start, acc = _build_nfa(node.parts[0], nfa)
        for part in node.parts[1:]:
            s2, a2 = _build_nfa(part, nfa)
            nfa.eps[acc].append(s2)
            acc = a2
        return start, acc
    if isinstance(node, _Alt):
        s, a = nfa.state(), nfa.state()
        for opt in node.options:
            os_, oa = _build_nfa(opt, nfa)
            nfa.eps[s].append(os_)
            nfa.eps[oa].append(a)
        return s, a
    if isinstance(node, _Repeat):
        if node.max is None:
            # min copies then a Kleene loop
            s = nfa.state()
            cur = s
            for _ in range(node.min):
                fs, fa = _build_nfa(node.node, nfa)
                nfa.eps[cur].append(fs)
                cur = fa
            loop_s, loop_a = _build_nfa(node.node, nfa)
            acc = nfa.state()
            nfa.eps[cur].append(loop_s)
            nfa.eps[cur].append(acc)
            nfa.eps[loop_a].append(loop_s)
            nfa.eps[loop_a].append(acc)
            return s, acc
        # bounded: min mandatory copies + (max - min) optional ones
        s = nfa.state()
        acc = nfa.state()
        cur = s
        for _ in range(node.min):
            fs, fa = _build_nfa(node.node, nfa)
            nfa.eps[cur].append(fs)
            cur = fa
        for _ in range(node.max - node.min):
            nfa.eps[cur].append(acc)  # may stop here
            fs, fa = _build_nfa(node.node, nfa)
            nfa.eps[cur].append(fs)
            cur = fa
        nfa.eps[cur].append(acc)
        return s, acc
    raise AssertionError(f"unknown AST node {node!r}")


# ------------------------------------------------------------------------ DFA


class CharDfa:
    """Deterministic automaton over disjoint codepoint segments.

    `boundaries` are segment start codepoints (sorted); a character maps to
    segment `bisect_right(boundaries, cp) - 1`. `trans[state]` maps segment
    index → next state; missing entries are the dead state. Every state in
    the machine can still reach an accepting state (dead states are pruned),
    so "has a transition" is exactly "the match can still complete".
    """

    def __init__(self, boundaries: list[int], trans: list[dict[int, int]],
                 accepting: frozenset[int], start: int):
        self.boundaries = boundaries
        self.trans = trans
        self.accepting = accepting
        self.start = start

    @property
    def num_states(self) -> int:
        return len(self.trans)

    def segment_of(self, cp: int) -> int:
        return bisect_right(self.boundaries, cp) - 1

    def step(self, state: int, ch: str) -> int | None:
        return self.trans[state].get(self.segment_of(ord(ch)))

    def walk(self, state: int, text: str) -> int | None:
        """Advance through every char of `text`; None once the match dies."""
        for ch in text:
            state = self.trans[state].get(self.segment_of(ord(ch)))
            if state is None:
                return None
        return state

    def is_accepting(self, state: int) -> bool:
        return state in self.accepting

    def live_segments(self, state: int):
        return self.trans[state].keys()


def compile_regex(pattern: str) -> CharDfa:
    """Full pipeline: parse, NFA, subset-construct, prune dead states."""
    ast = _Parser(pattern).parse()
    nfa = _Nfa()
    start, accept = _build_nfa(ast, nfa)

    # Disjoint alphabet segments from every range boundary in the NFA.
    points = {0}
    for edges in nfa.edges:
        for ranges, _ in edges:
            for lo, hi in ranges:
                points.add(lo)
                if hi + 1 <= MAX_CODEPOINT:
                    points.add(hi + 1)
    boundaries = sorted(points)
    nseg = len(boundaries)

    def seg_range(seg: int) -> tuple[int, int]:
        lo = boundaries[seg]
        hi = (boundaries[seg + 1] - 1) if seg + 1 < nseg else MAX_CODEPOINT
        return lo, hi

    def eps_closure(states: frozenset[int]) -> frozenset[int]:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = eps_closure(frozenset({start}))
    index: dict[frozenset[int], int] = {start_set: 0}
    order = [start_set]
    trans: list[dict[int, int]] = [{}]
    work = [start_set]
    while work:
        cur = work.pop()
        ci = index[cur]
        # segment → set of NFA targets
        by_seg: dict[int, set[int]] = {}
        for s in cur:
            for ranges, tgt in nfa.edges[s]:
                for lo, hi in ranges:
                    seg = bisect_right(boundaries, lo) - 1
                    while seg < nseg:
                        slo, shi = seg_range(seg)
                        if slo > hi:
                            break
                        by_seg.setdefault(seg, set()).add(tgt)
                        seg += 1
        for seg, tgts in by_seg.items():
            nxt = eps_closure(frozenset(tgts))
            ni = index.get(nxt)
            if ni is None:
                ni = index[nxt] = len(order)
                order.append(nxt)
                trans.append({})
                work.append(nxt)
            trans[ci][seg] = ni

    accepting = {i for i, st in enumerate(order) if accept in st}

    # Prune states that cannot reach acceptance (a transition into one is a
    # guaranteed dead match — masking must treat it as disallowed).
    reverse: dict[int, set[int]] = {}
    for i, t in enumerate(trans):
        for nxt in t.values():
            reverse.setdefault(nxt, set()).add(i)
    live = set(accepting)
    stack = list(accepting)
    while stack:
        s = stack.pop()
        for p in reverse.get(s, ()):
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise RegexSyntaxError(f"pattern matches nothing: {pattern!r}")
    remap = {old: new for new, old in enumerate(sorted(live))}
    pruned = [
        {seg: remap[n] for seg, n in trans[old].items() if n in live}
        for old in sorted(live)
    ]
    return CharDfa(
        boundaries=boundaries,
        trans=pruned,
        accepting=frozenset(remap[s] for s in accepting),
        start=remap[0],
    )
