"""Declarative UI component model: charts/tables/text as JSON.

Reference: ``deeplearning4j-ui-components/.../components/**`` —
ChartLine/ChartScatter/ChartHistogram/ChartStackedArea/ChartTimeline,
ComponentTable, ComponentText, ComponentDiv + Style classes, rendered by a
JS frontend from their JSON form.

Port: a copy of ``deeplearning4j_tpu/ui/components.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


class Component:
    component_type = "Component"

    def to_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


@dataclass
class StyleChart:
    """≙ ``components/chart/style/StyleChart.java`` (subset)."""

    width: float = 640
    height: float = 420
    title_color: str = "#333333"
    series_colors: Optional[List[str]] = None

    def to_dict(self):
        return {k: v for k, v in self.__dict__.items() if v is not None}


class ChartLine(Component):
    """≙ ``components/chart/ChartLine.java``."""

    component_type = "ChartLine"

    def __init__(self, title: str, style: Optional[StyleChart] = None):
        self.title = title
        self.style = style or StyleChart()
        self.series: List[Dict[str, Any]] = []

    def add_series(self, name: str, x: Sequence[float], y: Sequence[float]):
        self.series.append({"name": name, "x": list(map(float, x)),
                            "y": list(map(float, y))})
        return self

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "style": self.style.to_dict(), "series": self.series}


class ChartScatter(ChartLine):
    """≙ ``components/chart/ChartScatter.java``."""

    component_type = "ChartScatter"


class ChartHistogram(Component):
    """≙ ``components/chart/ChartHistogram.java``."""

    component_type = "ChartHistogram"

    def __init__(self, title: str, style: Optional[StyleChart] = None):
        self.title = title
        self.style = style or StyleChart()
        self.bins: List[Dict[str, float]] = []

    def add_bin(self, lower: float, upper: float, y: float):
        self.bins.append({"lower": float(lower), "upper": float(upper),
                          "y": float(y)})
        return self

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "style": self.style.to_dict(), "bins": self.bins}


class ChartStackedArea(ChartLine):
    """≙ ``components/chart/ChartStackedArea.java``."""

    component_type = "ChartStackedArea"


class ComponentTable(Component):
    """≙ ``components/table/ComponentTable.java``."""

    component_type = "ComponentTable"

    def __init__(self, header: Sequence[str],
                 rows: Sequence[Sequence[Any]] = ()):
        self.header = list(header)
        self.rows = [list(map(str, r)) for r in rows]

    def add_row(self, *cells):
        self.rows.append(list(map(str, cells)))
        return self

    def to_dict(self):
        return {"componentType": self.component_type, "header": self.header,
                "content": self.rows}


class ComponentText(Component):
    """≙ ``components/text/ComponentText.java``."""

    component_type = "ComponentText"

    def __init__(self, text: str):
        self.text = text

    def to_dict(self):
        return {"componentType": self.component_type, "text": self.text}


class ComponentDiv(Component):
    """≙ ``components/component/ComponentDiv.java`` — container."""

    component_type = "ComponentDiv"

    def __init__(self, *children: Component):
        self.children = list(children)

    def to_dict(self):
        return {"componentType": self.component_type,
                "components": [c.to_dict() for c in self.children]}


def component_from_dict(d: Dict[str, Any]) -> Component:
    t = d.get("componentType")
    if t in ("ChartLine", "ChartScatter", "ChartStackedArea"):
        cls = {"ChartLine": ChartLine, "ChartScatter": ChartScatter,
               "ChartStackedArea": ChartStackedArea}[t]
        c = cls(d["title"])
        for s in d.get("series", []):
            c.add_series(s["name"], s["x"], s["y"])
        return c
    if t == "ChartHistogram":
        c = ChartHistogram(d["title"])
        for b in d.get("bins", []):
            c.add_bin(b["lower"], b["upper"], b["y"])
        return c
    if t == "ComponentTable":
        return ComponentTable(d["header"], d.get("content", []))
    if t == "ComponentText":
        return ComponentText(d["text"])
    if t == "ComponentDiv":
        return ComponentDiv(*[component_from_dict(x)
                              for x in d.get("components", [])])
    raise ValueError(f"Unknown componentType '{t}'")
