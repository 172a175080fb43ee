"""Minimal HTML → markdown conversion for remote knowledge sources.

Parity target: the HTML→markdown step of the reference Confluence loader
(``src/knowledge/sources/confluence.ts`` ``convertConfluenceToMarkdown``),
which flattens Confluence "storage format" (XHTML) into headed markdown that
the section chunker (`chunker.py`) can split. Implemented on the stdlib
``html.parser`` — no external deps.
"""

from __future__ import annotations

from html.parser import HTMLParser

_HEADINGS = {f"h{i}": "#" * i for i in range(1, 7)}
_SKIP = {"script", "style", "head"}


class _Converter(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.out: list[str] = []
        self._skip_depth = 0
        self._list_stack: list[str] = []  # "ul" | "ol"
        self._ol_counters: list[int] = []
        self._in_pre = False
        self._cell_buf: list[str] | None = None
        self._row: list[str] = []
        self._table_rows: list[list[str]] = []
        self._in_table = False
        self._href: str | None = None
        self._link_text: list[str] = []

    # -- helpers ---------------------------------------------------------
    def _emit(self, text: str) -> None:
        # An open link captures text first — even inside a table cell — so
        # </a> can rebuild [text](href) into whatever encloses the link.
        if self._href is not None:
            self._link_text.append(text)
        elif self._cell_buf is not None:
            self._cell_buf.append(text)
        else:
            self.out.append(text)

    def _newline(self, n: int = 1) -> None:
        if self._cell_buf is not None:
            return
        self.out.append("\n" * n)

    def _buf(self) -> list[str]:
        if self._href is not None:
            return self._link_text
        if self._cell_buf is not None:
            return self._cell_buf
        return self.out

    def _close_inline(self, marker: str) -> None:
        """Close ** / * / ` flush against the wrapped text, not its space."""
        buf = self._buf()
        if buf and buf[-1].endswith(" "):
            buf[-1] = buf[-1][:-1]
            buf.append(marker + " ")
        else:
            buf.append(marker)

    # -- parser hooks ----------------------------------------------------
    def handle_starttag(self, tag, attrs):
        if tag in _SKIP:
            self._skip_depth += 1
            return
        attrs = dict(attrs)
        if tag in _HEADINGS:
            self._newline(2)
            self._emit(_HEADINGS[tag] + " ")
        elif tag == "p":
            self._newline(2)
        elif tag == "br":
            self._newline()
        elif tag in ("ul", "ol"):
            self._list_stack.append(tag)
            if tag == "ol":
                self._ol_counters.append(0)
            self._newline()
        elif tag == "li":
            self._newline()
            indent = "  " * (len(self._list_stack) - 1)
            if self._list_stack and self._list_stack[-1] == "ol":
                self._ol_counters[-1] += 1
                self._emit(f"{indent}{self._ol_counters[-1]}. ")
            else:
                self._emit(f"{indent}- ")
        elif tag == "pre":
            self._in_pre = True
            self._newline(2)
            self._emit("```\n")
        elif tag == "code" and not self._in_pre:
            self._emit("`")
        elif tag in ("strong", "b"):
            self._emit("**")
        elif tag in ("em", "i"):
            self._emit("*")
        elif tag == "a":
            self._href = attrs.get("href", "")
            self._link_text = []
        elif tag == "table":
            self._in_table = True
            self._table_rows = []
        elif tag == "tr":
            self._row = []
        elif tag in ("td", "th"):
            self._cell_buf = []
        elif tag == "hr":
            self._newline(2)
            self._emit("---")
            self._newline()

    def handle_endtag(self, tag):
        if tag in _SKIP:
            self._skip_depth = max(0, self._skip_depth - 1)
            return
        if tag in _HEADINGS or tag == "p":
            self._newline()
        elif tag in ("ul", "ol"):
            if self._list_stack:
                popped = self._list_stack.pop()
                if popped == "ol" and self._ol_counters:
                    self._ol_counters.pop()
            self._newline()
        elif tag == "pre":
            self._in_pre = False
            self._emit("\n```")
            self._newline(2)
        elif tag == "code" and not self._in_pre:
            self._close_inline("`")
        elif tag in ("strong", "b"):
            self._close_inline("**")
        elif tag in ("em", "i"):
            self._close_inline("*")
        elif tag == "a":
            text = "".join(self._link_text).strip()
            href = self._href or ""
            self._href = None
            self._link_text = []
            target = self._cell_buf if self._cell_buf is not None else self.out
            if text and href and not href.startswith("#"):
                target.append(f"[{text}]({href})")
            else:
                target.append(text)
        elif tag in ("td", "th"):
            self._row.append(" ".join("".join(self._cell_buf or []).split()))
            self._cell_buf = None
        elif tag == "tr":
            if self._row:
                self._table_rows.append(self._row)
            self._row = []
        elif tag == "table":
            self._in_table = False
            self._emit_table()

    def handle_data(self, data):
        if self._skip_depth:
            return
        if self._in_pre:
            self._emit(data)
        else:
            text = " ".join(data.split())
            if text:
                buf = self._buf()
                prev = buf[-1] if buf else ""
                # Whitespace between elements is collapsed, not dropped:
                # "</a> more" keeps its separating space ("[x](u) more").
                if data[:1].isspace() and prev and not prev[-1].isspace():
                    text = " " + text
                self._emit(text + " " if not self._in_table or self._cell_buf is not None else text)

    def _emit_table(self) -> None:
        if not self._table_rows:
            return
        self._newline(2)
        header, *rows = self._table_rows
        width = max(len(header), *(len(r) for r in rows)) if rows else len(header)
        header += [""] * (width - len(header))
        self.out.append("| " + " | ".join(header) + " |\n")
        self.out.append("|" + "---|" * width + "\n")
        for row in rows:
            row = row + [""] * (width - len(row))
            self.out.append("| " + " | ".join(row) + " |\n")
        self._newline()


def html_to_markdown(html: str) -> str:
    parser = _Converter()
    parser.feed(html)
    parser.close()
    text = "".join(parser.out)
    # Collapse runs of blank lines and trailing space.
    lines = [ln.rstrip() for ln in text.split("\n")]
    out: list[str] = []
    for ln in lines:
        if ln == "" and out and out[-1] == "":
            continue
        out.append(ln)
    return "\n".join(out).strip()
