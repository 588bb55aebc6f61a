"""Result tables: rows keyed by an index column (``Scene``), without pandas.

The JAX package builds its evaluation tables as pandas DataFrames
(train/loop.py ``eval_errors_list2df``, ``get_dummy_train_stats``;
utils/observability.py ``write_results``). :class:`Table` does the few
things the drivers need, with pandas' semantics where they show in a file:

- columns in order of first appearance over the rows; a missing entry is
  NaN;
- a column of Python ints stays ints, one that mixes ints with floats or
  NaN becomes floats (pandas' int64 and float64 columns);
- :meth:`with_mean` appends a ``Mean`` row, each numeric column's mean over
  its non-NaN entries (``DataFrame.mean(numeric_only=True)``);
- :meth:`round` rounds as ``np.round``; :meth:`join` adds another table's
  columns by index; :meth:`concat` stacks rows, keeping duplicates;
- :meth:`to_csv` writes what ``DataFrame.to_csv(na_rep="NULL")`` writes (the
  index first, floats as their shortest round-trip repr, ``NULL`` for NaN),
  and :meth:`read_csv` reads such a file back with ``pd.read_csv``'s types.
"""

from __future__ import annotations

import csv
import math
import re
import warnings
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

NAN = float("nan")
_INT = re.compile(r"[+-]?\d+")


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)


def _plain(v):
    """numpy scalars as Python ones; None as NaN."""
    if v is None:
        return NAN
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


class Table:
    def __init__(self, index_name: str = "Scene", columns: Optional[List[str]] = None,
                 rows: Optional[List[Tuple[Any, Dict[str, Any]]]] = None):
        self.index_name = index_name
        self.columns: List[str] = list(columns or [])
        self.rows: List[Tuple[Any, Dict[str, Any]]] = [(k, dict(r)) for k, r in (rows or [])]
        self._normalize()

    @classmethod
    def from_records(cls, records: Iterable[Dict[str, Any]], index: str = "Scene") -> "Table":
        """One row per record, keyed by its ``index`` entry."""
        columns: List[str] = []
        rows = []
        for rec in records:
            rec = dict(rec)
            key = rec.pop(index)
            for c in rec:
                if c not in columns:
                    columns.append(c)
            rows.append((key, rec))
        return cls(index, columns, rows)

    def _normalize(self) -> None:
        """Fill missing entries with NaN and give each column one kind:
        ints, floats, or whatever else it holds."""
        for _, r in self.rows:
            for c in self.columns:
                r[c] = _plain(r.get(c, NAN))
        for c in self.columns:
            vals = [r[c] for _, r in self.rows]
            if all(_is_number(v) for v in vals) and not all(isinstance(v, int) for v in vals):
                for _, r in self.rows:
                    r[c] = float(r[c])

    # -- reading -----------------------------------------------------------

    @property
    def index(self) -> List[Any]:
        return [k for k, _ in self.rows]

    def __len__(self) -> int:
        return len(self.rows)

    def numeric_columns(self) -> List[str]:
        return [c for c in self.columns if all(_is_number(r[c]) for _, r in self.rows)]

    def column(self, name: str) -> List[Any]:
        if name not in self.columns:
            raise KeyError(name)
        return [r[name] for _, r in self.rows]

    def loc(self, key, column: str):
        """The one entry at row ``key`` and ``column`` (``KeyError`` where
        either is missing, ``ValueError`` where ``key`` names several rows)."""
        if column not in self.columns:
            raise KeyError(column)
        hits = [r[column] for k, r in self.rows if k == key]
        if not hits:
            raise KeyError(key)
        if len(hits) > 1:
            raise ValueError(f"{len(hits)} rows have {self.index_name} = {key!r}")
        return hits[0]

    # -- new tables --------------------------------------------------------

    def with_mean(self, name: str = "Mean") -> "Table":
        """The table with a row ``name`` of each numeric column's NaN-skipping
        mean (NaN where a column holds no number); the other columns NaN."""
        mean = {}
        for c in self.numeric_columns():
            vals = np.asarray(self.column(c), dtype=np.float64)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                mean[c] = float(np.nanmean(vals)) if vals.size else NAN
        rows = [(k, {c: (float(v) if _is_number(v) and c in mean else v) for c, v in r.items()})
                for k, r in self.rows]
        return Table(self.index_name, self.columns, rows + [(name, mean)])

    def drop(self, key) -> "Table":
        if key not in self.index:
            raise KeyError(key)
        return Table(self.index_name, self.columns, [(k, r) for k, r in self.rows if k != key])

    def round(self, decimals: int) -> "Table":
        rows = []
        for k, r in self.rows:
            rows.append((k, {c: (v if isinstance(v, int) or not _is_number(v)
                                 else float(np.round(np.float64(v), decimals)))
                             for c, v in r.items()}))
        return Table(self.index_name, self.columns, rows)

    def join(self, other: "Table") -> "Table":
        """This table's rows with ``other``'s columns added by index (NaN
        where ``other`` has no such row)."""
        extra = [c for c in other.columns if c not in self.columns]
        theirs = {k: r for k, r in other.rows}
        rows = [(k, {**r, **{c: theirs.get(k, {}).get(c, NAN) for c in extra}})
                for k, r in self.rows]
        return Table(self.index_name, self.columns + extra, rows)

    def concat(self, other: "Table") -> "Table":
        """This table's rows, then ``other``'s; the columns' union in order
        of first appearance."""
        columns = self.columns + [c for c in other.columns if c not in self.columns]
        return Table(self.index_name, columns, self.rows + other.rows)

    # -- files and text ----------------------------------------------------

    @staticmethod
    def _cell(v, na_rep: str) -> str:
        if isinstance(v, float):
            return na_rep if math.isnan(v) else repr(v)
        return str(v)

    def to_csv(self, path: str, na_rep: str = "NULL") -> str:
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([self.index_name] + self.columns)
            for k, r in self.rows:
                w.writerow([self._cell(k, na_rep)] + [self._cell(r[c], na_rep)
                                                      for c in self.columns])
        return path

    @staticmethod
    def _parse(s: str):
        if s in ("", "NULL", "NaN", "nan", "NA", "N/A", "null", "None"):
            return NAN
        if _INT.fullmatch(s):
            return int(s)
        try:
            return float(s)
        except ValueError:
            return s

    @classmethod
    def read_csv(cls, path: str) -> "Table":
        """A file of :meth:`to_csv` (or pandas' ``to_csv``); the first column
        is the index."""
        with open(path, newline="") as f:
            lines = list(csv.reader(f))
        header, body = lines[0], lines[1:]
        rows = [(cls._parse(line[0]),
                 {c: cls._parse(v) for c, v in zip(header[1:], line[1:])}) for line in body]
        return cls(header[0], header[1:], rows)

    def to_string(self) -> str:
        def fmt(v):
            if isinstance(v, float):
                return "NaN" if math.isnan(v) else f"{v:.6g}"
            return str(v)

        cells = [[self.index_name] + self.columns]
        cells += [[fmt(k)] + [fmt(r[c]) for c in self.columns] for k, r in self.rows]
        widths = [max(len(row[j]) for row in cells) for j in range(len(cells[0]))]
        return "\n".join("  ".join(s.rjust(w) if j else s.ljust(w)
                                   for j, (s, w) in enumerate(zip(row, widths)))
                         for row in cells)
