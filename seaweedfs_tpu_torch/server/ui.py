"""Server status UIs (counterpart of `seaweedfs_tpu/server/ui.py`, whole;
reference: weed/server/master_ui/templates.go,
volume_server_ui/templates.go, filer_ui/ — templated HTML status pages).

`render` composes a page from sections; a section value may be:
  - Table(headers, rows)  -> an HTML table (volume lists, EC shard maps)
  - str                   -> preformatted text
  - anything else         -> pretty-printed JSON in <pre>
Every page carries nav links (metrics / status JSON) like the reference's
operator pages.
"""

from __future__ import annotations

import html
import json
from dataclasses import dataclass


@dataclass
class Table:
    headers: list[str]
    rows: list[list[object]]


_STYLE = (
    "body{font-family:-apple-system,'Segoe UI',sans-serif;margin:2em;"
    "background:#fafafa;color:#222}"
    "h1{font-size:1.3em}h2{font-size:1.05em;margin-top:1.5em}"
    "pre{background:#fff;border:1px solid #ddd;padding:1em;overflow:auto}"
    "table{border-collapse:collapse;background:#fff;min-width:40%}"
    "th,td{border:1px solid #ddd;padding:.3em .7em;text-align:left;"
    "font-size:.9em}th{background:#f0f0f0}"
    "tr:nth-child(even){background:#f9f9f9}"
    "nav a{margin-right:1em}"
    ".num{text-align:right;font-variant-numeric:tabular-nums}"
)


def _cell(v: object) -> str:
    cls = " class='num'" if isinstance(v, (int, float)) and \
        not isinstance(v, bool) else ""
    if isinstance(v, bool):
        v = "yes" if v else "no"
    return f"<td{cls}>{html.escape(str(v))}</td>"


def render(title: str, sections: dict[str, object],
           links: dict[str, str] | None = None) -> str:
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        f"<style>{_STYLE}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
    ]
    if links:
        parts.append("<nav>" + "".join(
            f"<a href='{html.escape(href)}'>{html.escape(name)}</a>"
            for name, href in links.items()) + "</nav>")
    for name, value in sections.items():
        parts.append(f"<h2>{html.escape(name)}</h2>")
        if isinstance(value, Table):
            parts.append("<table><tr>" + "".join(
                f"<th>{html.escape(h)}</th>" for h in value.headers)
                + "</tr>")
            for row in value.rows:
                parts.append("<tr>" + "".join(_cell(c) for c in row)
                             + "</tr>")
            parts.append("</table>")
            if not value.rows:
                parts.append("<p><em>none</em></p>")
        elif isinstance(value, str):
            parts.append(f"<pre>{html.escape(value)}</pre>")
        else:
            body = json.dumps(value, indent=1, default=str)
            parts.append(f"<pre>{html.escape(body)}</pre>")
    parts.append("</body></html>")
    return "".join(parts)


def fmt_bytes(n: object) -> str:
    try:
        v = float(n)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return str(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if v < 1024 or unit == "TiB":
            return f"{v:.1f} {unit}" if unit != "B" else f"{int(v)} B"
        v /= 1024
    return str(n)
