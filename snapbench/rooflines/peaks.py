"""The table of peaks, by card name."""

from __future__ import annotations

import json
from pathlib import Path

TABLE = Path(__file__).with_name("peaks.json")


def peaks(kind: str) -> dict | None:
    """The card's published peaks, or ``None`` for a card the table lacks."""
    return json.loads(TABLE.read_text()).get(kind)
