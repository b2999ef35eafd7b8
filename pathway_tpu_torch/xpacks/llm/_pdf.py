"""Pure-Python PDF text extraction (the ``PypdfParser`` fallback engine).

The reference delegates PDF parsing to the ``pypdf`` library
(``xpacks/llm/parsers.py:955``); where no PDF library is installed,
this module implements the text path directly from the PDF spec with the
stdlib only: object/stream scanning, FlateDecode (zlib) decompression, and a
content-stream tokenizer for the text-showing operators (``Tj``, ``'``,
``"``, ``TJ``) with literal-string escapes, hex strings, and line-break
operators (``Td``/``TD``/``T*``/``ET``).

Scope (documented limitation, not a stub): simple-encoding fonts
(Standard/WinAnsi — the overwhelming default for machine-generated text
PDFs) extract faithfully; CID/Type0 composite fonts yield raw code bytes.
Encrypted PDFs are rejected."""

from __future__ import annotations

import re
import zlib

_STREAM_RE = re.compile(rb"stream\r?\n")


def _object_streams(data: bytes) -> list[tuple[bytes, bytes]]:
    """(object-dict bytes, raw stream bytes) for every stream object."""
    out = []
    pos = 0
    while True:
        m = _STREAM_RE.search(data, pos)
        if m is None:
            break
        start = m.end()
        end = data.find(b"endstream", start)
        if end < 0:
            break
        # the stream's dict sits between the previous "obj" keyword and "stream"
        head_start = data.rfind(b"obj", 0, m.start())
        head = data[head_start:m.start()] if head_start >= 0 else b""
        body = data[start:end]
        # strip the single trailing EOL the spec puts before "endstream"
        if body.endswith(b"\r\n"):
            body = body[:-2]
        elif body.endswith(b"\n") or body.endswith(b"\r"):
            body = body[:-1]
        out.append((head, body))
        pos = end + len(b"endstream")
    return out


def _decode(head: bytes, body: bytes) -> bytes | None:
    if b"FlateDecode" in head:
        try:
            return zlib.decompress(body)
        except zlib.error:
            return None
    if b"Filter" in head:
        return None  # DCT/LZW/etc: not text content
    return body


_ESCAPES = {
    b"n": b"\n",
    b"r": b"\r",
    b"t": b"\t",
    b"b": b"\b",
    b"f": b"\f",
    b"(": b"(",
    b")": b")",
    b"\\": b"\\",
}


def _parse_literal(data: bytes, i: int) -> tuple[bytes, int]:
    """Parse a ``(...)`` literal string starting at the '('; returns (bytes,
    index past the closing paren). Handles escapes and balanced parens."""
    out = bytearray()
    depth = 1
    i += 1
    n = len(data)
    while i < n and depth > 0:
        c = data[i : i + 1]
        if c == b"\\":
            nxt = data[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
            elif nxt in b"01234567" and nxt != b"":  # octal \ddd (1-3 digits)
                j = i + 1
                while j < min(i + 4, n) and data[j : j + 1] in b"01234567" and data[j:j+1] != b"":
                    j += 1
                out.append(int(data[i + 1 : j], 8) & 0xFF)
                i = j
            elif nxt in (b"\n", b"\r"):  # line continuation
                i += 2
                if nxt == b"\r" and data[i : i + 1] == b"\n":
                    i += 1
            else:
                out += nxt
                i += 2
        elif c == b"(":
            depth += 1
            out += c
            i += 1
        elif c == b")":
            depth -= 1
            if depth > 0:
                out += c
            i += 1
        else:
            out += c
            i += 1
    return bytes(out), i


def _parse_hex(data: bytes, i: int) -> tuple[bytes, int]:
    end = data.find(b">", i)
    if end < 0:
        return b"", len(data)
    hx = re.sub(rb"\s", b"", data[i + 1 : end])
    if len(hx) % 2:
        hx += b"0"
    try:
        return bytes.fromhex(hx.decode("ascii")), end + 1
    except ValueError:
        return b"", end + 1


_TOKEN_RE = re.compile(rb"[A-Za-z'\"*]+")


def _content_text(content: bytes) -> str:
    """Walk one content stream, collecting shown strings in order."""
    parts: list[str] = []
    pending: list[bytes] = []  # strings since the last operator

    def flush_shown() -> None:
        for s in pending:
            parts.append(s.decode("latin-1"))
        pending.clear()

    i, n = 0, len(content)
    in_text = False
    while i < n:
        c = content[i : i + 1]
        if c == b"(":
            s, i = _parse_literal(content, i)
            pending.append(s)
            continue
        if c == b"<":
            if content[i : i + 2] == b"<<":  # dict, skip both
                i += 2
                continue
            s, i = _parse_hex(content, i)
            pending.append(s)
            continue
        if c == b"%":  # comment to EOL
            j = content.find(b"\n", i)
            i = n if j < 0 else j + 1
            continue
        m = _TOKEN_RE.match(content, i)
        if m is None:
            i += 1
            if c not in b"[]":
                # a number/name between strings is not a separator inside TJ
                pass
            continue
        tok = m.group()
        i = m.end()
        if tok == b"BT":
            in_text = True
            pending.clear()
            continue
        if tok == b"ET":
            in_text = False
            if parts and not parts[-1].endswith("\n"):
                parts.append("\n")
            pending.clear()
            continue
        if not in_text:
            pending.clear()
            continue
        if tok in (b"Tj", b"TJ"):
            flush_shown()
        elif tok == b"'":
            parts.append("\n")
            flush_shown()
        elif tok == b'"':
            parts.append("\n")
            flush_shown()
        elif tok in (b"Td", b"TD", b"T*"):
            if parts and not parts[-1].endswith("\n"):
                parts.append("\n")
            pending.clear()
        else:
            # positioning/font operator: its operands were not shown text
            pending.clear()
    return "".join(parts)


def extract_pdf_text(data: bytes) -> str:
    """All text shown by the document's content streams, page order as laid
    out in the file."""
    if not data.startswith(b"%PDF"):
        raise ValueError("not a PDF document")
    if b"/Encrypt" in data[-2048:] or b"/Encrypt" in data[:2048]:
        raise ValueError("encrypted PDFs are not supported")
    texts = []
    for head, body in _object_streams(data):
        decoded = _decode(head, body)
        if decoded is None or b"BT" not in decoded:
            continue
        text = _content_text(decoded)
        if text.strip():
            texts.append(text)
    return "".join(texts)
