"""The port's own copy of `llmlb_tpu/structured/openai_api.py`.

OpenAI-dialect structured-output request parsing, shared by both layers.

The gateway calls `inspect_request` to validate `response_format` /
`tool_choice` up front (malformed shapes and unsupported JSON-Schema features
become a 400 with the feature named, instead of being proxied blind); the
tpu:// engine calls it again to build the actual constraint spec it hands the
scheduler. Both layers therefore agree on exactly one notion of "valid".

Anthropic `/v1/messages` bodies are converted to OpenAI chat shape before
reaching this module (gateway/api_anthropic.anthropic_request_to_openai), so
forced `tool_choice: {type: "tool"}` arrives here as a forced function call.
"""

from __future__ import annotations

import dataclasses

from llmlb_tpu_torch.structured.json_schema import schema_to_regex
from llmlb_tpu_torch.structured.constraint import spec_regex


@dataclasses.dataclass(frozen=True)
class StructuredRequest:
    """What a request asked for, normalized.

    kind: "json_object" | "json_schema" | "tool_call"
    spec: the wire-safe constraint spec for SamplingParams.constraint
    tool_name: set for kind == "tool_call" (response shaping needs it)
    """

    kind: str
    spec: dict
    tool_name: str | None = None


def _tool_by_name(tools, name: str) -> dict | None:
    for tool in tools or []:
        if not isinstance(tool, dict):
            continue
        fn = tool.get("function") or {}
        if isinstance(fn, dict) and fn.get("name") == name:
            return fn
    return None


def _forced_tool(body: dict) -> dict | None:
    """The function dict of a forced tool call, None when tool choice is
    auto/none/absent. Raises ValueError for malformed shapes."""
    choice = body.get("tool_choice")
    if choice is None or choice in ("auto", "none"):
        return None
    tools = body.get("tools")
    if choice == "required":
        if not isinstance(tools, list) or not tools:
            raise ValueError("tool_choice 'required' needs a 'tools' array")
        if len(tools) != 1:
            # Cannot constrain "one of several tools" to a single arguments
            # grammar; pass through unconstrained rather than guessing.
            return None
        fn = (tools[0] or {}).get("function")
        if not isinstance(fn, dict) or not fn.get("name"):
            raise ValueError("tools[0].function.name is required")
        return fn
    if isinstance(choice, dict):
        if choice.get("type") != "function":
            raise ValueError(
                f"unsupported tool_choice type {choice.get('type')!r}"
            )
        name = (choice.get("function") or {}).get("name")
        if not isinstance(name, str) or not name:
            raise ValueError("tool_choice.function.name is required")
        fn = _tool_by_name(tools, name)
        if fn is None:
            raise ValueError(f"tool_choice names unknown function {name!r}")
        return fn
    raise ValueError("tool_choice must be 'auto', 'none', 'required', "
                     "or a {type: 'function'} object")


def inspect_request(body: dict) -> StructuredRequest | None:
    """Parse + validate the structured-output fields of an OpenAI chat body.

    Returns None for unconstrained requests. Raises ValueError (including
    UnsupportedSchemaError, whose message names the offending feature) for
    malformed or uncompilable requests — the caller maps that to a 400.
    """
    rf = body.get("response_format")
    forced = _forced_tool(body)

    structured: StructuredRequest | None = None
    if rf is not None:
        if not isinstance(rf, dict):
            raise ValueError("response_format must be an object")
        rtype = rf.get("type")
        if rtype in (None, "text"):
            structured = None
        elif rtype == "json_object":
            structured = StructuredRequest(
                kind="json_object", spec={"type": "json_object"}
            )
        elif rtype == "json_schema":
            js = rf.get("json_schema")
            if not isinstance(js, dict):
                raise ValueError(
                    "response_format.json_schema must be an object"
                )
            schema = js.get("schema")
            if not isinstance(schema, (dict, bool)):
                raise ValueError(
                    "response_format.json_schema.schema must be an object"
                )
            schema_to_regex(schema)  # raises UnsupportedSchemaError early
            structured = StructuredRequest(
                kind="json_schema",
                spec={"type": "json_schema", "schema": schema},
            )
        else:
            raise ValueError(
                f"unsupported response_format type {rtype!r} (expected "
                f"'text', 'json_object', or 'json_schema')"
            )

    if forced is not None:
        if structured is not None:
            raise ValueError(
                "response_format and a forced tool_choice cannot be combined"
            )
        schema = forced.get("parameters")
        if schema is None:
            schema = {"type": "object"}  # parameterless tool: any object
        if not isinstance(schema, (dict, bool)):
            raise ValueError("tool function parameters must be an object")
        spec = {"type": "tool_call", "name": forced["name"], "schema": schema}
        spec_regex(spec)  # raises UnsupportedSchemaError early
        return StructuredRequest(
            kind="tool_call", spec=spec, tool_name=forced["name"]
        )
    return structured


def parse_seed(body: dict) -> int | None:
    """OpenAI `seed`: plumbed to the engine's per-request PRNG fold."""
    seed = body.get("seed")
    if seed is None:
        return None
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise ValueError("'seed' must be an integer")
    # fold into uint32 space; OpenAI allows arbitrary ints
    return seed & 0x7FFFFFFF
