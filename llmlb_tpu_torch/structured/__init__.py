"""Structured outputs for the port's engine: its own copy of
`llmlb_tpu/structured/` (pure Python and numpy; the port imports nothing of
the JAX package). Grammar-constrained decoding for the engine.

Pipeline (each stage its own module):

    JSON Schema ──json_schema.py──▶ regex ──regex_dfa.py──▶ char DFA
        ──constraint.py──▶ per-state token masks over the vocabulary
        ──engine──▶ [B, V] additive logit bias, applied BEFORE the top-k
                    sampling prefilter (ops/sampling.py)

`openai_api.inspect_request` is the single notion of a valid structured
request, shared by the gateway (early 400s) and the engine (actual
constraint construction). See docs/structured-outputs.md.
"""

from llmlb_tpu_torch.structured.constraint import (
    MASK_NEG,
    ConstraintCompiler,
    ConstraintState,
    TokenConstraint,
    spec_hash,
    spec_regex,
)
from llmlb_tpu_torch.structured.json_schema import (
    UnsupportedSchemaError,
    any_object_regex,
    schema_to_regex,
)
from llmlb_tpu_torch.structured.openai_api import (
    StructuredRequest,
    inspect_request,
    parse_seed,
)
from llmlb_tpu_torch.structured.regex_dfa import (
    CharDfa,
    RegexSyntaxError,
    compile_regex,
)

__all__ = [
    "MASK_NEG",
    "CharDfa",
    "ConstraintCompiler",
    "ConstraintState",
    "RegexSyntaxError",
    "StructuredRequest",
    "TokenConstraint",
    "UnsupportedSchemaError",
    "any_object_regex",
    "compile_regex",
    "inspect_request",
    "parse_seed",
    "schema_to_regex",
    "spec_hash",
    "spec_regex",
]
