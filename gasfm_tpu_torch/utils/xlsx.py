"""Minimal dependency-free .xlsx writer.

A copy of the JAX package's utils/xlsx.py, writing the port's
:class:`~gasfm_tpu_torch.utils.tables.Table`. The reference persists its
result tables as Excel files (``df.to_excel`` — reference
code/utils/general_utils.py:61-77); with no xlsx engine as a dependency,
this module implements the small subset of OOXML that a single-sheet DataFrame
dump needs: a zip container with the content-types/relationship boilerplate
and one worksheet using inline strings (no sharedStrings table). Readable
by Excel/LibreOffice/pandas+openpyxl.
"""

from __future__ import annotations

import zipfile
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(idx: int) -> str:
    """0-based column index -> A1-style column letters."""
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def _cell(row: int, col: int, value) -> str:
    ref = f"{_col_name(col)}{row}"
    if value is None:
        return ""
    if isinstance(value, float) and value != value:  # NaN
        return ""
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, float) and (value == float("inf") or value == float("-inf")):
        # OOXML numeric cells cannot hold infinities ('<v>inf</v>' corrupts
        # the file for Excel/openpyxl); Excel itself has no inf — write the
        # IEEE name as an inline string, like pandas' to_excel does.
        return f'<c r="{ref}" t="inlineStr"><is><t>{value!r}</t></is></c>'
    if isinstance(value, (int, float)):
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t>{text}</t></is></c>'


def write_xlsx(path: str, table) -> str:
    """Write a :class:`~gasfm_tpu_torch.utils.tables.Table` (index included)
    as a single-sheet xlsx."""
    header = [table.index_name or ""] + [str(c) for c in table.columns]
    rows_xml = []
    cells = "".join(_cell(1, j, h) for j, h in enumerate(header))
    rows_xml.append(f'<row r="1">{cells}</row>')
    for i, (idx, row) in enumerate(table.rows, start=2):
        values = [idx] + [row[c] for c in table.columns]
        cells = "".join(_cell(i, j, v) for j, v in enumerate(values))
        rows_xml.append(f'<row r="{i}">{cells}</row>')

    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f'<sheetData>{"".join(rows_xml)}</sheetData></worksheet>'
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return path
