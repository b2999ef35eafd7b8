"""Document parsers (reference ``xpacks/llm/parsers.py:46-955``).

Parsers are UDFs ``bytes -> list[(text, metadata)]``. ``Utf8Parser`` is native;
the heavyweight ones (Unstructured, Docling, vision-LLM Image/Slide parsers,
pypdf) gate on their libraries at construction.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.udfs import UDF


class Utf8Parser(UDF):
    """Decode UTF-8 bytes into one text chunk (reference ``parsers.py:46``)."""

    def __init__(self, **kwargs):
        def parse(contents: Any) -> list:
            if isinstance(contents, bytes):
                text = contents.decode("utf-8", errors="replace")
            else:
                text = str(contents)
            return [(text, {})]

        super().__init__(_fn=parse, return_type=list, **kwargs)


ParseUtf8 = Utf8Parser  # deprecated reference alias


def _gated(name: str, module: str):
    class _Gated(UDF):
        def __init__(self, *args, **kwargs):
            raise ImportError(
                f"{name} requires the `{module}` package, which is not available "
                f"in this environment; use Utf8Parser or a custom UDF parser"
            )

    _Gated.__name__ = name
    return _Gated


class PypdfParser(UDF):
    """PDF → text chunks (reference ``parsers.py:955``). Uses ``pypdf`` when
    importable; otherwise the pure-Python extraction engine
    (``xpacks/llm/_pdf.py`` — stdlib-only object/FlateDecode/content-stream
    parsing), so DocumentStore ingests real PDFs without pypdf too.

    ``apply_text_cleanup`` collapses whitespace runs like the reference."""

    def __init__(self, apply_text_cleanup: bool = True, **kwargs):
        import re as _re

        def parse(contents: Any) -> list:
            if isinstance(contents, bytes):
                data = contents
            elif isinstance(contents, str):
                data = contents.encode("latin-1", errors="replace")
            else:
                data = bytes(contents)
            try:
                import pypdf  # noqa: F401
                from io import BytesIO

                reader = pypdf.PdfReader(BytesIO(data))
                text = "\n".join(page.extract_text() or "" for page in reader.pages)
            except ImportError:
                from pathway_tpu_torch.xpacks.llm._pdf import extract_pdf_text

                text = extract_pdf_text(data)
            if apply_text_cleanup:
                text = _re.sub(r"[ \t]+", " ", text)
                text = _re.sub(r"\n{3,}", "\n\n", text).strip()
            return [(text, {})]

        super().__init__(_fn=parse, return_type=list, **kwargs)


class DocxParser(UDF):
    """DOCX → text: stdlib zip + WordprocessingML XML extraction
    (``_docs.extract_docx_text``) — paragraphs, line breaks, tables. The
    reference routes .docx through unstructured (``parsers.py:82``); this
    parser is native to the image."""

    def __init__(self, apply_text_cleanup: bool = True, **kwargs):
        import re as _re

        def parse(contents: Any) -> list:
            from pathway_tpu_torch.xpacks.llm._docs import extract_docx_text

            data = contents if isinstance(contents, bytes) else bytes(contents)
            text = extract_docx_text(data)
            if apply_text_cleanup:
                text = _re.sub(r"[ \t]+", " ", text)
                text = _re.sub(r"\n{3,}", "\n\n", text).strip()
            return [(text, {})]

        super().__init__(_fn=parse, return_type=list, **kwargs)


class HtmlParser(UDF):
    """HTML → text: ``html.parser``-based extraction — script/style
    dropped, block structure preserved as line breaks, page title in the
    chunk metadata."""

    def __init__(self, **kwargs):
        def parse(contents: Any) -> list:
            from pathway_tpu_torch.xpacks.llm._docs import extract_html_text

            text, meta = extract_html_text(
                contents if isinstance(contents, (bytes, str)) else bytes(contents)
            )
            return [(text, meta)]

        super().__init__(_fn=parse, return_type=list, **kwargs)


class MarkdownParser(UDF):
    """Markdown → plain text: headings/lists/emphasis/links stripped to
    their text, fenced code kept as content."""

    def __init__(self, **kwargs):
        def parse(contents: Any) -> list:
            from pathway_tpu_torch.xpacks.llm._docs import extract_markdown_text

            return [
                (
                    extract_markdown_text(
                        contents
                        if isinstance(contents, (bytes, str))
                        else bytes(contents)
                    ),
                    {},
                )
            ]

        super().__init__(_fn=parse, return_type=list, **kwargs)


UnstructuredParser = _gated("UnstructuredParser", "unstructured")
ParseUnstructured = UnstructuredParser
DoclingParser = _gated("DoclingParser", "docling")
ImageParser = _gated("ImageParser", "openparse")
SlideParser = _gated("SlideParser", "openparse")
