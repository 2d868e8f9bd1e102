"""YAML reading that works without PyYAML for JSON-flow documents."""

from __future__ import annotations

import json


def read_yaml_config(path: str) -> dict:
    """Parse a model's YAML config. Without PyYAML installed, only JSON-flow
    YAML (a JSON document, which is valid YAML) can be read."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as exc:
            raise RuntimeError(
                f"{path}: PyYAML is not installed, and the file is not "
                f"JSON-flow YAML ({exc})") from exc
    return yaml.load(text, Loader=yaml.FullLoader)
