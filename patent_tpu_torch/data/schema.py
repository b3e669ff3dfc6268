"""Record type and naming conventions of the DeepPatent corpus (the port's
copy of patent_tpu/data/schema.py).

Figure filenames encode the patent and grant date:
``USD0806928-20180102-D00001_1.png`` → patent ``USD0806928``, date
``20180102``.  CPC codes are hierarchical: ``A01G`` (medium / subclass) →
``A01`` (big / class) → ``A`` (main / section).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable

FIGURE_NAME_RE = re.compile(
    r"^(?P<patent>[A-Z]{2,4}\d+)-(?P<date>\d{8})-(?P<fig>.+)$")


@dataclasses.dataclass(frozen=True)
class FigureRecord:
    """One figure row of the metadata table."""

    figure_id: str      # subfigure file name, e.g. USD0806928-20180102-D00001_1.png
    patent_id: str      # e.g. USD0806928
    medium_cpc: str     # subclass, e.g. A01G
    big_cpc: str        # class,    e.g. A01
    main_cpc: str       # section,  e.g. A


def parse_figure_name(name: str) -> tuple[str, int, int, int] | None:
    """Figure file name → (patent_id, year, month, day); None if it does
    not parse."""
    m = FIGURE_NAME_RE.match(name)
    if not m:
        return None
    date = m.group("date")
    return m.group("patent"), int(date[:4]), int(date[4:6]), int(date[6:8])


def cpc_levels(cpc_code: str) -> tuple[str, str, str]:
    """CPC code → (medium, big, main): 'A01G63/02' → ('A01G', 'A01', 'A')."""
    code = cpc_code.strip()
    return code[:4], code[:3], code[:1]


def records_from_metadata(metadata: Iterable[dict],
                          max_month: int | None = None) -> list[FigureRecord]:
    """Metadata JSON records → FigureRecords, keeping grant months up to
    ``max_month``.  Records whose filename does not parse or that carry no
    CPC are dropped, as the reference drops them."""
    out = []
    for item in metadata:
        name = item.get("subfigure_file") or item.get("figure_id")
        if not name:
            continue
        parsed = parse_figure_name(name)
        if parsed is None:
            continue
        patent, _year, month, _day = parsed
        if max_month is not None and month > max_month:
            continue
        cpc = item.get("cpc") or item.get("main_cpc") or item.get("cpc_codes")
        if isinstance(cpc, (list, tuple)):
            cpc = cpc[0] if cpc else None
        if not cpc:
            continue
        medium, big, main = cpc_levels(str(cpc))
        out.append(FigureRecord(figure_id=name, patent_id=patent,
                                medium_cpc=medium, big_cpc=big, main_cpc=main))
    return out
