"""Small string utilities: Stringify, Tokenizer, StringLine, XmlReader.

Ports of the reference's minor L4 helpers (tools/misc/impl/Stringify.hpp,
Tokenizer.hpp/.cpp, StringLine.hpp, XmlReader.hpp/.cpp). XmlReader is an
event (SAX-style) reader matching the reference's observer notifications:
XmlTagOpenEvent / XmlTagCloseEvent / XmlTagTextEvent / XmlTagAttributeEvent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator


class Stringify:
    """printf-style formatting (Stringify.hpp:37)."""

    @staticmethod
    def format(fmt: str, *args) -> str:
        return fmt % args if args else fmt


class TokenizerIterator:
    """Token iterator over a string with delimiter characters
    (Tokenizer.hpp:36 TokenizerIterator: strtok-like semantics — runs of
    delimiters collapse, no empty tokens)."""

    def __init__(self, text: str, delimiters: str):
        self._tokens = []
        cur = []
        for c in text:
            if c in delimiters:
                if cur:
                    self._tokens.append("".join(cur))
                    cur = []
            else:
                cur.append(c)
        if cur:
            self._tokens.append("".join(cur))
        self._i = 0

    # reference pull-iterator protocol
    def first(self):
        self._i = 0

    def next(self):
        self._i += 1

    def is_done(self) -> bool:
        return self._i >= len(self._tokens)

    def item(self) -> str:
        return self._tokens[self._i]

    def __iter__(self) -> Iterator[str]:
        return iter(self._tokens)


class StringLine:
    """Line-wrap helper (StringLine.hpp): format a text to a given line
    width, breaking at spaces."""

    @staticmethod
    def format(text: str, width: int = 80, indent: int = 0) -> str:
        words = text.split()
        lines: list[str] = []
        cur = " " * indent
        for w in words:
            if len(cur) + len(w) + 1 > width and cur.strip():
                lines.append(cur.rstrip())
                cur = " " * indent
            cur += w + " "
        if cur.strip():
            lines.append(cur.rstrip())
        return "\n".join(lines)


@dataclass
class XmlEvent:
    kind: str      # 'open' | 'close' | 'text' | 'attribute'
    name: str
    value: str | None = None   # attribute value or None


class XmlReader:
    """Minimal event XML reader (XmlReader.cpp): emits open/close/text/
    attribute events in document order; entities &lt; &gt; &amp; &quot;
    &apos; unescaped in text (normalizeText equivalent)."""

    _ENTITIES = [("&lt;", "<"), ("&gt;", ">"), ("&quot;", '"'),
                 ("&apos;", "'"), ("&amp;", "&")]

    def __init__(self, stream):
        self._text = stream.read() if hasattr(stream, "read") else stream

    def _normalize(self, s: str) -> str:
        for old, new in self._ENTITIES:
            s = s.replace(old, new)
        return s

    def read(self) -> list[XmlEvent]:
        events: list[XmlEvent] = []
        i = 0
        text = self._text
        n = len(text)
        buf: list[str] = []
        while i < n:
            c = text[i]
            if c == "<":
                chunk = "".join(buf).strip()
                if chunk:
                    events.append(XmlEvent("text", self._normalize(chunk)))
                buf = []
                j = text.find(">", i)
                if j < 0:
                    break
                tag = text[i + 1:j].strip()
                i = j + 1
                if tag.startswith("?") or tag.startswith("!"):
                    continue
                if tag.startswith("/"):
                    events.append(XmlEvent("close", tag[1:].strip()))
                    continue
                selfclose = tag.endswith("/")
                if selfclose:
                    tag = tag[:-1].strip()
                parts = tag.split(None, 1)
                name = parts[0]
                events.append(XmlEvent("open", name))
                if len(parts) > 1:
                    import re

                    for m in re.finditer(r'(\w+)\s*=\s*"([^"]*)"', parts[1]):
                        events.append(XmlEvent(
                            "attribute", m.group(1),
                            self._normalize(m.group(2))))
                if selfclose:
                    events.append(XmlEvent("close", name))
            else:
                buf.append(c)
                i += 1
                continue
        return events
