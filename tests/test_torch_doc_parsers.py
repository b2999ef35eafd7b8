"""The port's document parsers (``pathway_tpu_torch/xpacks/llm``: ``_pdf``,
``_docs``, ``parsers``) against the JAX package's, on the same bytes.

Mirrors ``tests/test_doc_parsers.py`` and ``tests/test_pdf_rag.py`` (all but
``test_rag_evals_quality_floor``, which runs the reference's own benchmark
harness): each extraction gives the reference's text exactly, and a
DocumentStore that reads the files from disk with ``pw.io.fs`` (binary,
static, with metadata) through each parser gives the reference's update
stream, keys included.
"""

from __future__ import annotations

import io
import zipfile
import zlib

import pytest

import pathway_tpu
import pathway_tpu.stdlib.indexing
import pathway_tpu.xpacks.llm
import pathway_tpu_torch
from pathway_tpu.xpacks.llm import _docs as R_docs
from pathway_tpu.xpacks.llm import _pdf as R_pdf
from pathway_tpu_torch.xpacks.llm import _docs as T_docs
from pathway_tpu_torch.xpacks.llm import _pdf as T_pdf
from test_torch_llm_xpack import assert_same_streams, final_rows


def make_docx(paragraphs: list[str], table: list[list[str]] | None = None) -> bytes:
    w = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
    body = "".join(f'<w:p><w:r><w:t xml:space="preserve">{p}</w:t></w:r></w:p>' for p in paragraphs)
    if table:
        rows = ""
        for row in table:
            rows += "<w:tr>" + "".join(f"<w:tc><w:p><w:r><w:t>{c}</w:t></w:r></w:p></w:tc>" for c in row) + "</w:tr>"
        body += f"<w:tbl>{rows}</w:tbl>"
    doc = (
        f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<w:document xmlns:w="{w}"><w:body>{body}</w:body></w:document>'
    )
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(
            "[Content_Types].xml",
            '<?xml version="1.0"?><Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types"/>',
        )
        zf.writestr("word/document.xml", doc)
    return buf.getvalue()


def make_pdf(pages: list[str], compress: bool = False) -> bytes:
    """A minimal valid single-font PDF; each page shows its lines via Tj/Td."""
    objs: list[bytes] = []

    def add(body: bytes) -> int:
        objs.append(body)
        return len(objs)

    font = add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
    content_ids = []
    for text in pages:
        ops = [b"BT /F1 12 Tf 72 720 Td"]
        for j, line in enumerate(text.split("\n")):
            esc = line.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
            if j:
                ops.append(b"0 -14 Td")
            ops.append(b"(" + esc.encode("latin-1") + b") Tj")
        ops.append(b"ET")
        stream = b" ".join(ops)
        if compress:
            comp = zlib.compress(stream)
            body = b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(comp) + comp + b"\nendstream"
        else:
            body = b"<< /Length %d >>\nstream\n" % len(stream) + stream + b"\nendstream"
        content_ids.append(add(body))
    pages_id = len(objs) + len(pages) + 1
    page_ids = [
        add(
            b"<< /Type /Page /Parent %d 0 R /MediaBox [0 0 612 792] "
            b"/Resources << /Font << /F1 %d 0 R >> >> /Contents %d 0 R >>" % (pages_id, font, cid)
        )
        for cid in content_ids
    ]
    kids = b" ".join(b"%d 0 R" % p for p in page_ids)
    assert add(b"<< /Type /Pages /Kids [%s] /Count %d >>" % (kids, len(pages))) == pages_id
    catalog = add(b"<< /Type /Catalog /Pages %d 0 R >>" % pages_id)
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref_at = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += b"trailer\n<< /Size %d /Root %d 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (len(objs) + 1, catalog, xref_at)
    return bytes(out)


HTML = b"""<html><head><title>My Page</title>
<style>body { color: red }</style><script>var x = 1;</script></head>
<body><h1>Header</h1><p>First &amp; foremost.</p>
<div>Block <b>bold</b> text</div><ul><li>item one</li><li>item two</li></ul>
</body></html>"""

MARKDOWN = """# Title

Some **bold** and *italic* and `code` text.

- bullet one
- bullet two

1. numbered

[link text](https://example.com) and ![alt](img.png)

```python
x = 1
```

> quoted line

Setext Heading
==============

call my_var_name and obj__attr__x but _emph_ ok
"""


# ------------------------------------------------------------------- units
@pytest.mark.parametrize("compress", [False, True])
def test_pdf_extraction_matches_reference(compress):
    pdf = make_pdf(["Hello PDF world.\nSecond line.", "Page two (with parens) here."], compress=compress)
    text = T_pdf.extract_pdf_text(pdf)
    assert text == R_pdf.extract_pdf_text(pdf)
    assert "Hello PDF world.\nSecond line." in text.replace("\r", "")
    assert "Page two (with parens) here." in text


def test_pdf_tj_array_and_hex_match_reference():
    content = b"BT /F1 12 Tf 72 720 Td [(Spl) -20 (it wor) 5 (ds)] TJ T* <48492E> Tj ET"
    pdf = (
        b"%PDF-1.4\n1 0 obj\n<< /Length " + str(len(content)).encode() + b" >>\nstream\n"
        + content + b"\nendstream\nendobj\n%%EOF\n"
    )
    text = T_pdf.extract_pdf_text(pdf)
    assert text == R_pdf.extract_pdf_text(pdf)
    assert "Split words" in text.replace("\n", "") and "HI." in text


def test_pdf_rejects_non_pdf_and_encrypted():
    with pytest.raises(ValueError, match="not a PDF"):
        T_pdf.extract_pdf_text(b"hello")
    enc = make_pdf(["secret"]).replace(b"trailer\n<<", b"trailer\n<< /Encrypt 9 0 R")
    with pytest.raises(ValueError, match="encrypted"):
        T_pdf.extract_pdf_text(enc)


def test_docx_extraction_matches_reference():
    data = make_docx(["Hello world.", "Second paragraph."], table=[["name", "qty"], ["widget", "3"]])
    text = T_docs.extract_docx_text(data)
    assert text == R_docs.extract_docx_text(data)
    assert "name\tqty" in text and "widget\t3" in text
    assert text.index("Hello world.") < text.index("Second paragraph.")
    w = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
    doc = (
        f'<w:document xmlns:w="{w}"><w:body><w:p>'
        '<w:r><w:t>split</w:t></w:r><w:r><w:t xml:space="preserve"> run</w:t></w:r>'
        "<w:r><w:br/><w:t>after break</w:t></w:r>"
        "</w:p></w:body></w:document>"
    )
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("word/document.xml", doc)
    assert T_docs.extract_docx_text(buf.getvalue()) == "split run\nafter break"


def test_html_extraction_matches_reference():
    text, meta = T_docs.extract_html_text(HTML)
    assert (text, meta) == R_docs.extract_html_text(HTML)
    assert meta["title"] == "My Page" and "First & foremost." in text
    assert "color: red" not in text and "var x" not in text


def test_markdown_extraction_matches_reference():
    text = T_docs.extract_markdown_text(MARKDOWN)
    assert text == R_docs.extract_markdown_text(MARKDOWN)
    assert "Title" in text and "#" not in text and "**" not in text and "```" not in text
    assert "my_var_name" in text and "obj__attr__x" in text and "_emph_" not in text


PARSER_INPUTS = {  # built in the test: a zip carries its write time
    "Utf8Parser": lambda: "héllo wörld".encode(),
    "PypdfParser": lambda: make_pdf(["The  answer   is 42.\n\n\n\nEnd."], compress=True),
    "DocxParser": lambda: make_docx(["one  two", "three"]),
    "HtmlParser": lambda: HTML,
    "MarkdownParser": lambda: MARKDOWN.encode(),
}


@pytest.mark.parametrize("name", sorted(PARSER_INPUTS))
def test_parser_udfs_match_reference(name):
    data = PARSER_INPUTS[name]()

    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(data=bytes), [(data,)])
        return t.select(out=getattr(pw.xpacks.llm.parsers, name)()(pw.this.data))

    out = assert_same_streams(build)
    ((chunks,),) = final_rows(out["out"])
    assert len(chunks) == 1 and chunks[0][0]
    if name == "PypdfParser":
        assert "The answer is 42." in chunks[0][0]


@pytest.mark.parametrize("name", ["UnstructuredParser", "DoclingParser", "ImageParser", "SlideParser"])
def test_gated_parsers_raise(name):
    cls = getattr(pathway_tpu_torch.xpacks.llm.parsers, name)
    assert cls.__name__ == name
    with pytest.raises(ImportError, match="requires the"):
        cls()


# ------------------------------------------------- DocumentStore end-to-end
FILES = {
    "pdf": ("facts.pdf", make_pdf(["The secret launch code is ZEBRA-7.", "Unrelated second page."], compress=True),
            "PypdfParser", "secret launch code", "ZEBRA-7"),
    "docx": ("doc.docx", make_docx(["The launch window opens at dawn.", "Nothing else matters."]),
             "DocxParser", "launch window", "dawn"),
    "html": ("page.html", b"<html><head><title>t</title></head><body><p>The vault combination is 9-18-27.</p></body></html>",
             "HtmlParser", "vault combination", "9-18-27"),
    "md": ("notes.md", b"# Ops notes\n\nThe **rendezvous point** is the old lighthouse.\n",
           "MarkdownParser", "rendezvous point", "lighthouse"),
}


@pytest.mark.parametrize("fmt", sorted(FILES))
def test_document_store_ingests_files_like_reference(fmt, tmp_path):
    fname, data, parser, query, marker = FILES[fmt]
    (tmp_path / fname).write_bytes(data)

    def build(pw):
        docs = pw.io.fs.read(str(tmp_path), format="binary", mode="static", with_metadata=True)
        store = pw.xpacks.llm.DocumentStore(
            docs, retriever_factory=pw.stdlib.indexing.TantivyBM25Factory(),
            parser=getattr(pw.xpacks.llm.parsers, parser)(),
        )
        qs = pw.debug.table_from_rows(pw.xpacks.llm.DocumentStore.RetrieveQuerySchema, [(query, 1, None, None)])
        return {"hits": store.retrieve_query(qs), "chunks": store.chunked_docs.select(pw.this.text)}

    # the metadata's seen_at is the wall clock of each read: equal only
    # within one second, so it is left out of the comparison
    out = assert_same_streams(build, drop=("seen_at",))
    ((res,),) = final_rows(out["hits"])
    assert res[1] and marker in res[1][0]["text"]
    assert res[1][0]["metadata"]["path"].endswith(fname)
