"""Multi-document YAML config loading keyed by TypeMeta.

Mirrors the reference's config loader behavior of splitting a config
stream into typed documents by apiVersion/kind
(reference: pkg/config/config.go:271-405 Load/UnmarshalWithType and
FilterWithType :516-544).
"""

from __future__ import annotations

import io
from typing import Any, Dict, Iterable, List, Union

import yaml

from kwok_tpu_torch.api.types import API_VERSION, Stage


def load_documents(source: Union[str, "io.TextIOBase"]) -> List[Dict[str, Any]]:
    """Load all YAML documents from a path or a string of YAML."""
    if hasattr(source, "read"):
        text = source.read()
    elif isinstance(source, str) and "\n" not in source and source.endswith((".yaml", ".yml")):
        with open(source, "r", encoding="utf-8") as f:
            text = f.read()
    else:
        text = source
    return [d for d in yaml.safe_load_all(text) if d is not None]


def filter_by_kind(docs: Iterable[Dict[str, Any]], kind: str) -> List[Dict[str, Any]]:
    """Select documents of one kwok kind (config.go:516-544)."""
    out = []
    for d in docs:
        if d.get("kind") == kind and d.get("apiVersion", API_VERSION) == API_VERSION:
            out.append(d)
    return out


def load_stages(source: Union[str, "io.TextIOBase"]) -> List[Stage]:
    """Load all Stage documents from a YAML path/string."""
    return [Stage.from_dict(d) for d in filter_by_kind(load_documents(source), "Stage")]
