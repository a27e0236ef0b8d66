"""CSV manifest reading with separator fallback, on the standard library.

The port's copy of the JAX package's ``data/csv_utils.py`` without pandas:
the same separators in the same order (``α``, ``,``, tab, then a sniffed
one), the same rule that a separator giving a single column is the wrong
one, and the same check of expected columns. A manifest comes back as a
``Table``: its column names and one dict per row. Each column's values are
inferred as pandas infers them where the pipelines read them: a column
whose every filled cell is an integer holds ints, one whose every filled
cell is a number holds floats, anything else strings; an empty cell is
``None`` (pandas' NaN).
"""

from __future__ import annotations

import csv
import io
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

SEPARATORS = ["α", ",", "\t", None]  # None = sniffed


class Table:
    """Column names and rows (dicts) of a manifest."""

    def __init__(self, columns: List[str], rows: List[Dict[str, Any]]):
        self.columns = columns
        self.rows = rows

    def column(self, name: str) -> List[Any]:
        return [r.get(name) for r in self.rows]


def _infer(values: List[str]) -> List[Any]:
    """One column's cells: ints, else floats (ints too where a cell is
    empty, as pandas does), else strings."""
    filled = [v for v in values if v != ""]
    for kind in (int, float):
        try:
            conv = iter([kind(v) for v in filled])
        except ValueError:
            continue
        if kind is int and len(filled) < len(values):
            conv = iter([float(v) for v in filled])
        return [None if v == "" else next(conv) for v in values]
    return [None if v == "" else v for v in values]


def _read(text: str, sep: Optional[str]) -> Table:
    if sep is None:
        dialect = csv.Sniffer().sniff(text[:65536])
        reader = csv.reader(io.StringIO(text), dialect, doublequote=True)
    elif len(sep) == 1:
        reader = csv.reader(io.StringIO(text), delimiter=sep)
    else:  # pragma: no cover - every separator above is one character
        raise ValueError(sep)
    lines = [r for r in reader if r]
    if not lines:
        raise ValueError("empty manifest")
    columns, body = lines[0], lines[1:]
    cols = [_infer([r[i] if i < len(r) else "" for r in body])
            for i in range(len(columns))]
    rows = [{c: cols[i][j] for i, c in enumerate(columns)} for j in range(len(body))]
    return Table(columns, rows)


def read_csv_with_fallback(
    path: str | Path,
    expected_columns: Optional[Sequence[str]] = None,
) -> Table:
    text = Path(path).read_text(encoding="utf-8")
    last_err: Exception | None = None
    for sep in SEPARATORS:
        try:
            table = _read(text, sep)
        except Exception as e:
            last_err = e
            continue
        if len(table.columns) <= 1 and sep is not None:
            continue  # wrong separator: everything in one column
        if expected_columns and not set(expected_columns).issubset(table.columns):
            continue
        return table
    if last_err:
        raise last_err
    raise ValueError(f"could not parse {path} with any separator")


def write_csv(path: str | Path, columns: Sequence[str], rows: Sequence[Dict[str, Any]],
              sep: str = "α") -> None:
    """Rows to a manifest in the format pandas' ``to_csv(sep=sep,
    index=False)`` writes: minimal quoting, ``\\n`` line ends, a missing
    value or a NaN as an empty cell."""
    def cell(v):
        return "" if v is None or (isinstance(v, float) and math.isnan(v)) else v

    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([cell(r.get(c)) for c in columns])
