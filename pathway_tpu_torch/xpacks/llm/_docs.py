"""Pure-Python document text extraction: DOCX, HTML, Markdown.

Widens DocumentStore ingestion beyond txt/PDF without optional libraries
(reference parsers delegate to unstructured/docling —
``xpacks/llm/parsers.py:82-955``):

- DOCX is a zip of WordprocessingML parts (stdlib ``zipfile`` + ElementTree):
  paragraph runs join per ``<w:p>``, table cells join with tabs, line/page
  breaks honored.
- HTML goes through ``html.parser``: script/style/head dropped, block
  elements break lines, entities decoded, the title captured as metadata.
- Markdown strips formatting down to plain text: ATX/setext headings, lists,
  emphasis, inline/fenced code (code text kept), links/images to their text.
"""

from __future__ import annotations

import io
import re
import zipfile
from html.parser import HTMLParser
from xml.etree import ElementTree as ET

_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"


def extract_docx_text(data: bytes) -> str:
    """word/document.xml → plain text, one line per paragraph; table rows
    join their cells with tabs."""
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        xml = zf.read("word/document.xml")
    root = ET.fromstring(xml)
    body = root.find(f"{_W}body")
    if body is None:
        return ""
    lines: list[str] = []
    for child in body:
        if child.tag == f"{_W}p":
            lines.append(_docx_paragraph(child))
        elif child.tag == f"{_W}tbl":
            for row in child.iter(f"{_W}tr"):
                cells = [
                    " ".join(_docx_paragraph(p) for p in cell.iter(f"{_W}p"))
                    for cell in row.findall(f"{_W}tc")
                ]
                lines.append("\t".join(cells))
    return "\n".join(lines).strip()


def _docx_paragraph(p) -> str:
    parts: list[str] = []
    for node in p.iter():
        if node.tag == f"{_W}t":
            parts.append(node.text or "")
        elif node.tag in (f"{_W}br", f"{_W}cr"):
            parts.append("\n")
        elif node.tag == f"{_W}tab":
            parts.append("\t")
    return "".join(parts)


class _TextHTMLParser(HTMLParser):
    _SKIP = {"script", "style", "head", "template"}
    _BLOCK = {
        "p", "div", "br", "li", "ul", "ol", "table", "tr", "h1", "h2", "h3",
        "h4", "h5", "h6", "section", "article", "header", "footer", "blockquote",
        "pre", "hr",
    }

    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.parts: list[str] = []
        self.title_parts: list[str] = []
        self._skip_depth = 0
        self._in_title = False

    def handle_starttag(self, tag, attrs):
        if tag in self._SKIP:
            self._skip_depth += 1
        if tag == "title":
            self._in_title = True
        if tag in self._BLOCK:
            self.parts.append("\n")

    def handle_endtag(self, tag):
        if tag in self._SKIP and self._skip_depth:
            self._skip_depth -= 1
        if tag == "title":
            self._in_title = False
        if tag in self._BLOCK:
            self.parts.append("\n")

    def handle_data(self, data):
        if self._in_title:
            self.title_parts.append(data)
            return
        if not self._skip_depth:
            self.parts.append(data)


def extract_html_text(data: bytes | str) -> tuple[str, dict]:
    """→ (text, metadata with the page title when present)."""
    html = data.decode("utf-8", errors="replace") if isinstance(data, bytes) else data
    p = _TextHTMLParser()
    p.feed(html)
    p.close()
    text = re.sub(r"[ \t]+", " ", "".join(p.parts))
    text = re.sub(r" ?\n ?", "\n", text)
    text = re.sub(r"\n{3,}", "\n\n", text).strip()
    meta: dict = {}
    title = "".join(p.title_parts).strip()
    if title:
        meta["title"] = title
    return text, meta


_MD_FENCE = re.compile(r"^(```|~~~).*$")
_MD_HEADING = re.compile(r"^\s{0,3}#{1,6}\s+")
_MD_SETEXT = re.compile(r"^\s{0,3}(=+|-+)\s*$")
_MD_LIST = re.compile(r"^(\s*)([-*+]|\d+[.)])\s+")
_MD_QUOTE = re.compile(r"^\s{0,3}>\s?")
_MD_IMAGE = re.compile(r"!\[([^\]]*)\]\([^)]*\)")
_MD_LINK = re.compile(r"\[([^\]]+)\]\([^)]*\)")
_MD_AUTOLINK = re.compile(r"<(https?://[^>]+)>")
# underscore emphasis must not match intraword (CommonMark: snake_case stays
# intact); asterisks have no such restriction
_MD_EMPH_STAR = re.compile(r"(\*\*\*|\*\*|\*)(?=\S)(.+?)(?<=\S)\1")
_MD_EMPH_UND = re.compile(r"(?<![\w])(___|__|_)(?=\S)(.+?)(?<=\S)\1(?![\w])")
_MD_CODE = re.compile(r"`([^`]*)`")
_MD_HR = re.compile(r"^\s{0,3}([-*_]\s*){3,}$")


def extract_markdown_text(data: bytes | str) -> str:
    md = data.decode("utf-8", errors="replace") if isinstance(data, bytes) else data
    out: list[str] = []
    in_fence = False
    for line in md.splitlines():
        if _MD_FENCE.match(line):
            in_fence = not in_fence
            continue
        if in_fence:
            out.append(line)  # code content is text, the fence markers are not
            continue
        if _MD_SETEXT.match(line) and out and out[-1].strip():
            continue  # setext underline decorates the previous heading line
        if _MD_HR.match(line):
            out.append("")
            continue
        line = _MD_HEADING.sub("", line)
        line = _MD_QUOTE.sub("", line)
        line = _MD_LIST.sub(r"\1", line)
        line = _MD_IMAGE.sub(r"\1", line)
        line = _MD_LINK.sub(r"\1", line)
        line = _MD_AUTOLINK.sub(r"\1", line)
        line = _MD_CODE.sub(r"\1", line)
        # emphasis markers peel from the outside in (***bold italic***)
        prev = None
        while prev != line:
            prev = line
            line = _MD_EMPH_STAR.sub(r"\2", line)
            line = _MD_EMPH_UND.sub(r"\2", line)
        out.append(line)
    text = "\n".join(out)
    return re.sub(r"\n{3,}", "\n\n", text).strip()
