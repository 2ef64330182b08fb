"""The port's own copy of `llmlb_tpu/structured/json_schema.py`.

JSON Schema → regular grammar, the front of the constraint pipeline.

Compiles the practical subset of JSON Schema that agentic clients actually
send (typed objects, enums, consts, bounded arrays, anyOf/oneOf, non-recursive
$ref) into a regex over the compact JSON serialization — no whitespace between
tokens, object keys in schema declaration order. The output is regular by
construction: anything that would need a stack (recursive $ref, unbounded
nesting in free-form mode) or that a regex cannot enforce (numeric ranges,
uniqueItems) raises UnsupportedSchemaError naming the feature, so the gateway
can 400 with a message instead of proxying a constraint the engine would
silently mis-enforce.

The regex dialect is the one `regex_dfa.py` accepts; everything emitted here
compiles there. Guarantee: any string matching the emitted regex parses as
JSON and validates against the schema (the bench asserts this end to end).
"""

from __future__ import annotations

import json

# JSON primitive grammars (compact form). Strings allow any non-control,
# non-quote, non-backslash character plus the standard escapes.
STRING_CHAR = (
    r'(?:[^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})'
)
STRING = f'"{STRING_CHAR}*"'
INTEGER = r"-?(?:0|[1-9][0-9]*)"
NUMBER = r"-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"
BOOLEAN = r"(?:true|false)"
NULL = r"null"

# Free-form JSON ("json_object" mode, or a schema with no type) is not
# regular; it is approximated by expanding values to this nesting depth.
DEFAULT_ANY_DEPTH = 3
# Optional properties multiply alternatives (every optional subset in
# declaration order must be a branch); 2^6 = 64 branches is the ceiling.
MAX_OPTIONAL_PROPERTIES = 6
MAX_STRING_LENGTH = 256  # aligns with regex_dfa.MAX_BOUNDED_REPEAT
MAX_ARRAY_ITEMS = 256  # same compile bound as strings
# Hard ceiling on the compiled grammar, checked at EVERY node: nested $refs
# with optional-property branches multiply (a sub-KB hostile schema can
# otherwise expand to gigabytes on the gateway event loop — classic
# billion-laughs), and the ceiling also bounds the engine's NFA/DFA size.
MAX_REGEX_LEN = 65536

# Keywords whose semantics a DFA cannot honor. Ignoring them would emit
# schema-INVALID output while claiming a guarantee, so they hard-fail.
_UNSUPPORTED_KEYWORDS = (
    "$dynamicRef", "$dynamicAnchor", "$recursiveRef", "patternProperties",
    "allOf", "not", "if", "then", "else", "unevaluatedProperties",
    "unevaluatedItems", "dependentSchemas", "dependentRequired",
    "propertyNames", "contains", "uniqueItems", "multipleOf",
    "minimum", "maximum", "exclusiveMinimum", "exclusiveMaximum",
    "minProperties", "maxProperties", "prefixItems",
)

_ESCAPE_CHARS = set("\\^$.|?*+()[]{}")


class UnsupportedSchemaError(ValueError):
    """Schema uses a feature outside the compilable subset. `feature` names
    it; the message (which reaches 400 bodies) always contains the name."""

    def __init__(self, feature: str, detail: str = ""):
        self.feature = feature
        msg = f"unsupported JSON-Schema feature: {feature}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def _lit(text: str) -> str:
    """Regex that matches `text` literally (our dialect's escaping)."""
    out = []
    for ch in text:
        if ch in _ESCAPE_CHARS:
            out.append("\\" + ch)
        elif ord(ch) < 0x20:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    return "".join(out)


def _json_literal(value) -> str:
    """Regex matching exactly the compact JSON serialization of `value`."""
    return _lit(json.dumps(value, separators=(",", ":"), ensure_ascii=False))


def _any_value(depth: int) -> str:
    scalars = [STRING, NUMBER, BOOLEAN, NULL]
    if depth <= 0:
        return "(?:" + "|".join(scalars) + ")"
    inner = _any_value(depth - 1)
    obj = f'\\{{(?:"{STRING_CHAR}*":{inner}(?:,"{STRING_CHAR}*":{inner})*)?\\}}'
    arr = f"\\[(?:{inner}(?:,{inner})*)?\\]"
    return "(?:" + "|".join(scalars + [obj, arr]) + ")"


def any_object_regex(depth: int = DEFAULT_ANY_DEPTH) -> str:
    """`response_format: json_object` — any JSON object, nesting bounded."""
    inner = _any_value(depth - 1)
    return f'\\{{(?:"{STRING_CHAR}*":{inner}(?:,"{STRING_CHAR}*":{inner})*)?\\}}'


# Codepoints a JSON string may not contain RAW (they need \-escaping):
# controls, the quote, the backslash. A user `pattern` whose language can
# include one of these would let the grammar force output that no longer
# parses as JSON — the subsystem's core guarantee.
_JSON_UNSAFE = ((0x00, 0x1F), (0x22, 0x22), (0x5C, 0x5C))


def _check_pattern(pattern) -> None:
    """Validate a `pattern` keyword at SCHEMA compile time: it must be
    syntactically inside the supported regex dialect (so the engine's DFA
    compile cannot fail later, after a stream is already committed), and its
    alphabet must stay clear of characters that need JSON escaping."""
    from llmlb_tpu_torch.structured.regex_dfa import RegexSyntaxError, compile_regex

    if not isinstance(pattern, str) or not pattern:
        raise UnsupportedSchemaError("pattern", "must be a non-empty string")
    try:
        dfa = compile_regex(pattern)
    except RegexSyntaxError as e:
        raise UnsupportedSchemaError("pattern", str(e)) from None
    bounds = dfa.boundaries
    for trans in dfa.trans:
        for seg in trans:
            lo = bounds[seg]
            hi = (bounds[seg + 1] - 1) if seg + 1 < len(bounds) else 0x10FFFF
            for ulo, uhi in _JSON_UNSAFE:
                if lo <= uhi and ulo <= hi:
                    raise UnsupportedSchemaError(
                        "pattern",
                        "may match a character that needs JSON string "
                        f"escaping (U+{max(lo, ulo):04X}); restrict the "
                        "pattern's character classes",
                    )


def _resolve_ref(ref: str, root: dict) -> dict:
    if not isinstance(ref, str) or not ref.startswith("#/"):
        raise UnsupportedSchemaError("$ref", f"only '#/...' refs, got {ref!r}")
    node: object = root
    for part in ref[2:].split("/"):
        part = part.replace("~1", "/").replace("~0", "~")
        if not isinstance(node, dict) or part not in node:
            raise UnsupportedSchemaError("$ref", f"unresolvable {ref!r}")
        node = node[part]
    if not isinstance(node, (dict, bool)):
        raise UnsupportedSchemaError("$ref", f"{ref!r} is not a schema")
    return node  # type: ignore[return-value]


def _string_regex(schema: dict) -> str:
    if "pattern" in schema:
        for kw in ("minLength", "maxLength"):
            if kw in schema:
                raise UnsupportedSchemaError(
                    "pattern", f"cannot combine with {kw}"
                )
        _check_pattern(schema["pattern"])
        # JSON Schema `pattern` is unanchored; constrained decoding treats it
        # as a full match of the string body (docs/structured-outputs.md).
        return f'"(?:{schema["pattern"]})"'
    lo = schema.get("minLength", 0)
    hi = schema.get("maxLength")
    if not isinstance(lo, int) or lo < 0:
        raise UnsupportedSchemaError("minLength", "must be a non-negative int")
    if hi is not None and (not isinstance(hi, int) or hi < lo):
        raise UnsupportedSchemaError("maxLength", "must be an int >= minLength")
    if max(lo, hi or 0) > MAX_STRING_LENGTH:
        raise UnsupportedSchemaError(
            "maxLength", f"bounds over {MAX_STRING_LENGTH} are not compilable"
        )
    if lo == 0 and hi is None:
        return STRING
    if hi is None:
        return f'"{STRING_CHAR}{{{lo},}}"'
    return f'"{STRING_CHAR}{{{lo},{hi}}}"'


def _array_regex(schema: dict, root: dict, depth: int,
                 active: frozenset) -> str:
    item = schema.get("items", True)
    inner = _compile(item, root, depth - 1, active)
    lo = schema.get("minItems", 0)
    hi = schema.get("maxItems")
    if not isinstance(lo, int) or lo < 0:
        raise UnsupportedSchemaError("minItems", "must be a non-negative int")
    if hi is not None and (not isinstance(hi, int) or hi < lo):
        raise UnsupportedSchemaError("maxItems", "must be an int >= minItems")
    if max(lo, hi or 0) > MAX_ARRAY_ITEMS:
        # mirror MAX_STRING_LENGTH: bounds past the repeat cap must fail HERE
        # (the gateway's validation pass), not at the engine's DFA compile
        # after a stream is already committed
        raise UnsupportedSchemaError(
            "maxItems", f"bounds over {MAX_ARRAY_ITEMS} are not compilable"
        )
    if hi is not None and hi == 0:
        return r"\[\]"
    if lo == 0:
        tail = f"(?:,{inner})*" if hi is None else f"(?:,{inner}){{0,{hi - 1}}}"
        return f"\\[(?:{inner}{tail})?\\]"
    tail = (f"(?:,{inner}){{{lo - 1},}}" if hi is None
            else f"(?:,{inner}){{{lo - 1},{hi - 1}}}")
    return f"\\[{inner}{tail}\\]"


def _object_regex(schema: dict, root: dict, depth: int,
                  active: frozenset) -> str:
    props = schema.get("properties")
    addl = schema.get("additionalProperties")
    if props is None:
        if isinstance(addl, dict):
            # map-shaped object: any keys, values per the addl schema
            inner = _compile(addl, root, depth - 1, active)
            return (f'\\{{(?:"{STRING_CHAR}*":{inner}'
                    f'(?:,"{STRING_CHAR}*":{inner})*)?\\}}')
        if addl in (None, True):
            # open object with no declared shape: free-form, depth-bounded
            return any_object_regex(max(1, depth))
        return r"\{\}"  # additionalProperties: false and no properties
    if not isinstance(props, dict):
        raise UnsupportedSchemaError("properties", "must be an object")
    if addl not in (None, False):
        raise UnsupportedSchemaError(
            "additionalProperties",
            "only false (closed objects) is supported with properties",
        )
    required = schema.get("required", [])
    if not isinstance(required, list):
        raise UnsupportedSchemaError("required", "must be an array")
    unknown = [k for k in required if k not in props]
    if unknown:
        raise UnsupportedSchemaError(
            "required", f"names undeclared properties {unknown!r}"
        )
    names = list(props)  # declaration order is emission order
    optional = [k for k in names if k not in set(required)]
    if len(optional) > MAX_OPTIONAL_PROPERTIES:
        raise UnsupportedSchemaError(
            "optional properties",
            f"{len(optional)} optional properties need "
            f"2^{len(optional)} branches; at most "
            f"{MAX_OPTIONAL_PROPERTIES} are supported",
        )
    members = {
        k: f'"{_lit(k)}":{_compile(v, root, depth - 1, active)}'
        for k, v in props.items()
    }
    # One branch per optional subset, keys always in declaration order.
    branches = []
    for bits in range(1 << len(optional)):
        chosen = {optional[i] for i in range(len(optional)) if bits >> i & 1}
        keys = [k for k in names if k in set(required) or k in chosen]
        branches.append(
            "\\{" + ",".join(members[k] for k in keys) + "\\}"
            if keys else r"\{\}"
        )
    seen: set[str] = set()
    unique = [b for b in branches if not (b in seen or seen.add(b))]
    return unique[0] if len(unique) == 1 else "(?:" + "|".join(unique) + ")"


def _compile(schema, root: dict, depth: int, active: frozenset) -> str:
    """Size-checked wrapper: every node's emitted regex is bounded, and since
    parents only concatenate/alternate checked children plus O(1) glue, the
    per-node check bounds the whole grammar — multiplicative expansion
    (repeated $refs under optional-property branches) fails fast instead of
    materializing gigabytes on the caller's thread."""
    out = _compile_node(schema, root, depth, active)
    if len(out) > MAX_REGEX_LEN:
        raise UnsupportedSchemaError(
            "schema complexity",
            f"compiled grammar exceeds {MAX_REGEX_LEN} characters; simplify "
            f"nested/optional/$ref structure",
        )
    return out


def _compile_node(schema, root: dict, depth: int, active: frozenset) -> str:
    if schema is True or schema == {}:
        return _any_value(max(0, depth))
    if schema is False:
        raise UnsupportedSchemaError("false schema", "matches nothing")
    if not isinstance(schema, dict):
        raise UnsupportedSchemaError("schema", f"must be an object, got "
                                               f"{type(schema).__name__}")
    for kw in _UNSUPPORTED_KEYWORDS:
        if kw in schema:
            raise UnsupportedSchemaError(kw)
    if depth < 0:
        raise UnsupportedSchemaError(
            "nesting depth", "schema nests deeper than the compilable bound"
        )

    if "$ref" in schema:
        ref = schema["$ref"]
        if ref in active:
            raise UnsupportedSchemaError("recursive $ref", str(ref))
        return _compile(_resolve_ref(ref, root), root, depth,
                        active | {ref})

    if "const" in schema:
        return _json_literal(schema["const"])
    if "enum" in schema:
        values = schema["enum"]
        if not isinstance(values, list) or not values:
            raise UnsupportedSchemaError("enum", "must be a non-empty array")
        return "(?:" + "|".join(_json_literal(v) for v in values) + ")"
    for combinator in ("anyOf", "oneOf"):
        if combinator in schema:
            subs = schema[combinator]
            if not isinstance(subs, list) or not subs:
                raise UnsupportedSchemaError(
                    combinator, "must be a non-empty array"
                )
            return "(?:" + "|".join(
                _compile(s, root, depth, active) for s in subs
            ) + ")"

    stype = schema.get("type")
    if isinstance(stype, list):
        if not stype:
            raise UnsupportedSchemaError("type", "empty type array")
        return "(?:" + "|".join(
            _compile({**schema, "type": t}, root, depth, active)
            for t in stype
        ) + ")"
    if stype is None:
        return _any_value(max(0, depth))
    if stype == "string":
        return _string_regex(schema)
    if stype == "integer":
        return INTEGER
    if stype == "number":
        return NUMBER
    if stype == "boolean":
        return BOOLEAN
    if stype == "null":
        return NULL
    if stype == "array":
        return _array_regex(schema, root, depth, active)
    if stype == "object":
        return _object_regex(schema, root, depth, active)
    raise UnsupportedSchemaError("type", f"unknown type {stype!r}")


def schema_to_regex(schema, *, depth: int = 8) -> str:
    """Compile a JSON Schema into an equivalent full-match regex.

    `depth` bounds nesting of free-form subtrees (schemas without a type);
    explicitly-typed nesting is naturally bounded by the schema itself but
    still counts against it, so pathological 100-level schemas fail instead
    of exploding the DFA.
    """
    root = schema if isinstance(schema, dict) else {}
    return _compile(schema, root, depth, frozenset())
