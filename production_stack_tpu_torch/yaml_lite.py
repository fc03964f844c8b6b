"""yaml_lite: the YAML the chart uses, read and written on the standard library.

``safe_load`` / ``safe_load_all`` return what PyYAML's ``yaml.safe_load`` /
``yaml.safe_load_all`` return, and ``safe_dump(v)`` writes the text of
``yaml.safe_dump(v, default_flow_style=False, sort_keys=False)``, on the
subset the chart's files, its example values and its rendered manifests use:

  * comments; ``---`` and ``...`` between documents;
  * block mappings and block sequences, a sequence at its parent key's
    indentation included;
  * plain (over several lines too), single-quoted and double-quoted scalars
    (every YAML escape, JSON's among them);
  * block scalars ``|`` and ``>`` with ``-`` / ``+`` chomping and an
    indentation digit;
  * flow sequences and mappings that close on their line (``[]``, ``{}``,
    ``["a", b]``, ``{a: 1}``);
  * YAML 1.1 resolution of plain scalars as PyYAML applies it: yes/no/on/off
    are bools, ``~`` and ``null`` null, a leading 0 octal, ``0x`` hex, ``0b``
    binary, ``_`` inside numbers, ``1:20`` base 60, a float needs a dot,
    ``.inf`` / ``.nan``, ``2001-12-14`` a date (with a time, a datetime).

The writer takes None, bools, ints, floats, strings, dates, lists, tuples
and dicts, at PyYAML's width of 80 columns with non-ASCII characters escaped.

Anything outside the subset raises ``YAMLError`` naming its line, and is
never read as something else: anchors, aliases, tags, directives, complex
(``?``) keys, merge keys, flow collections over several lines, tabs outside
quoted scalars, block scalars and comments. The writer refuses what PyYAML
would write with those: a key that is empty, spans lines or is long (128
characters with its tag), and one list or dict object reached twice.
"""

import datetime
import math
import re
from typing import Any, Iterator, List, Optional, Tuple

__all__ = ["YAMLError", "safe_load", "safe_load_all", "safe_dump"]


class YAMLError(ValueError):
    """Text that is not YAML, or YAML outside yaml_lite's subset (``line`` is
    1-based; 0 for a value the writer cannot write)."""

    def __init__(self, line: int, msg: str):
        super().__init__(f"line {line}: {msg}" if line else msg)
        self.line = line


# ------------------------------------------------------------ resolution
# The implicit types of YAML 1.1 (yaml.org/type), in the order PyYAML tries
# them. Only plain scalars are resolved; quoted and block scalars are str.
_RESOLVERS = (
    ("bool", re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF)$")),
    ("float", re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                         r"|[-+]?\.(?:inf|Inf|INF)"
                         r"|\.(?:nan|NaN|NAN))$")),
    ("int", re.compile(r"^(?:[-+]?0b[0-1_]+"
                       r"|[-+]?0[0-7_]+"
                       r"|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+"
                       r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")),
    ("merge", re.compile(r"^(?:<<)$")),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$")),
    ("timestamp", re.compile(
        r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")),
    ("value", re.compile(r"^(?:=)$")),
)
_TIMESTAMP = re.compile(
    r"^(?P<year>[0-9]{4})-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)"
    r"(?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9])"
    r":(?P<second>[0-9][0-9])(?:\.(?P<fraction>[0-9]*))?"
    r"(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)"
    r"(?::(?P<tz_minute>[0-9][0-9]))?))?)?$")
_BOOLS = {"yes": True, "true": True, "on": True,
          "no": False, "false": False, "off": False}


def _tag_of(text: str) -> str:
    """The type a plain scalar with this text resolves to."""
    for tag, rx in _RESOLVERS:
        if rx.match(text):
            return tag
    return "str"


def _sexagesimal(text: str, part):
    value = 0
    for digit in text.split(":"):
        value = value * 60 + part(digit)
    return value


def _plain_value(text: str, line: int, key: bool = False) -> Any:
    tag = _tag_of(text)
    if tag == "str" or (key and tag == "value"):
        return text         # PyYAML reads a key "=" as the string "="
    if tag == "null":
        return None
    if tag == "bool":
        return _BOOLS[text.lower()]
    if tag == "int":
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits == "0":
            return 0
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits[0] == "0":
            return sign * int(digits, 8)
        if ":" in digits:
            return sign * _sexagesimal(digits, int)
        return sign * int(digits)
    if tag == "float":
        digits = text.replace("_", "").lower()
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits == ".inf":
            return sign * math.inf
        if digits == ".nan":
            return math.nan
        if ":" in digits:
            return sign * _sexagesimal(digits, float)
        return sign * float(digits)
    if tag == "timestamp":
        m = _TIMESTAMP.match(text)
        year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
        if not m["hour"]:
            return datetime.date(year, month, day)
        fraction = int((m["fraction"] or "")[:6].ljust(6, "0"))
        tz = None
        if m["tz_sign"]:
            delta = datetime.timedelta(hours=int(m["tz_hour"]),
                                       minutes=int(m["tz_minute"] or 0))
            tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
        elif m["tz"]:
            tz = datetime.timezone.utc
        return datetime.datetime(year, month, day, int(m["hour"]), int(m["minute"]),
                                 int(m["second"]), fraction, tzinfo=tz)
    raise YAMLError(line, f"the plain scalar {text!r} is a YAML {tag} key "
                          "(outside yaml_lite's subset)")


# ---------------------------------------------------------------- reader
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_NON_PRINTABLE = re.compile("[^\t\n\r\x20-\x7e\x85\xa0-\ud7ff\ue000-\ufffd"
                            "\U00010000-\U0010ffff]")
_OTHER_BREAKS = re.compile("[\r\x85\u2028\u2029]")
_NO_PLAIN_START = ",[]{}#&*!|>'\"%@`"
_FLOW_END = ",[]{}"


class _Reader:
    """A block-structure reader over the text's lines: each method takes the
    (row, column) where its node starts and returns the value and the row of
    the first line it did not consume."""

    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise YAMLError(text.count("\n", 0, bad.start()) + 1,
                            f"the character {bad.group()!r} is not printable")
        text = text.replace("\r\n", "\n")
        bad = _OTHER_BREAKS.search(text)
        if bad:
            raise YAMLError(text.count("\n", 0, bad.start()) + 1,
                            f"the line break {bad.group()!r} (only \\n and \\r\\n "
                            "end a line in yaml_lite)")
        self.lines = text.split("\n")
        self.n = len(self.lines)

    def fail(self, row: int, msg: str):
        raise YAMLError(row + 1, msg)

    # ------------------------------------------------------------ lines
    def eof(self, row: int, col: int) -> bool:
        return row == self.n - 1 and col >= len(self.lines[row])

    def marker(self, row: int) -> Optional[str]:
        """'---' or '...' where the line is a document marker."""
        line = self.lines[row]
        if line[:3] in ("---", "...") and (len(line) == 3 or line[3] in " \t"):
            return line[:3]
        return None

    def indent(self, row: int) -> int:
        line = self.lines[row]
        col = len(line) - len(line.lstrip(" "))
        if col < len(line) and line[col] == "\t":
            self.fail(row, "a tab where YAML allows only spaces")
        return col

    def rest_is_blank(self, row: int, col: int) -> bool:
        """Only spaces, and a comment after one, from ``col`` to the line end."""
        line = self.lines[row]
        i = col
        while i < len(line) and line[i] == " ":
            i += 1
        if i < len(line) and line[i] == "\t":
            self.fail(row, "a tab where YAML allows only spaces")
        return i == len(line) or (line[i] == "#" and (i == 0 or line[i - 1] in " \t"))

    def skip(self, row: int) -> int:
        """The first row at or after ``row`` with content (a node or a
        document marker), or ``self.n``."""
        while row < self.n and self.rest_is_blank(row, 0):
            row += 1
        return row

    def is_entry(self, row: int, col: int) -> bool:
        """A block sequence entry ``-`` at (row, col)."""
        line = self.lines[row]
        if col < len(line) and line[col] == "-":
            if col + 1 == len(line) or line[col + 1] == " ":
                return True
            if line[col + 1] == "\t":
                self.fail(row, "a tab where YAML allows only spaces")
        return False

    def value_after(self, row: int, col: int) -> bool:
        """A mapping value indicator ``:`` at (row, col)."""
        line = self.lines[row]
        if col < len(line) and line[col] == ":":
            if col + 1 == len(line) or line[col + 1] == " ":
                return True
            if line[col + 1] == "\t":
                self.fail(row, "a tab where YAML allows only spaces")
        return False

    # -------------------------------------------------------- documents
    def documents(self) -> Iterator[Any]:
        row = self.skip(0)
        if row < self.n and self.marker(row) == "...":
            self.fail(row, "expected the node content, but found '...'")
        if row < self.n and self.marker(row) is None:
            value, row = self.node(row, self.indent(row), -1, "line")
            yield value
            row = self.skip(row)
        while True:
            while row < self.n and self.marker(row) == "...":
                self.check_marker_line(row)
                row = self.skip(row + 1)
            if row >= self.n:
                return
            if self.marker(row) != "---":
                self.fail(row, "expected a document start '---' or the end of "
                               "the stream")
            self.check_marker_line(row)
            row = self.skip(row + 1)
            if row >= self.n or self.marker(row) is not None:
                yield None
                continue
            value, row = self.node(row, self.indent(row), -1, "line")
            yield value
            row = self.skip(row)

    def check_marker_line(self, row: int) -> None:
        if not self.rest_is_blank(row, 3):
            self.fail(row, "content on a document marker's line is outside "
                           "yaml_lite's subset")

    # ------------------------------------------------------------ nodes
    def node(self, row: int, col: int, parent: int, ctx: str) -> Tuple[Any, int]:
        """The node starting at (row, col). ``parent`` is the column of the
        enclosing block collection (-1 at the root); ``ctx`` is "line" at a
        line's start, "entry" after ``- ``, "value" after ``key: ``."""
        line = self.lines[row]
        ch = line[col]
        if ch == "%" and col == 0:
            self.fail(row, "directives are outside yaml_lite's subset")
        if self.is_entry(row, col):
            if ctx == "value":
                self.fail(row, "a block sequence may not start on its key's line")
            return self.sequence(row, col)
        if ch in "|>":
            return self.block_scalar(row, col, parent)
        if ch in "[{":
            value, end = self.flow(row, col)
            if self.value_after(row, self.skip_spaces(row, end)):
                self.fail(row, "a flow collection as a key is outside yaml_lite's "
                               "subset")
            if not self.rest_is_blank(row, end):
                self.fail(row, "unexpected text after a flow collection")
            return value, row + 1
        if ch in "'\"":
            value, end_row, end = self.quoted(row, col)
            after = self.skip_spaces(end_row, end)
            if self.value_after(end_row, after):
                if ctx == "value":
                    self.fail(row, "a mapping may not start on its key's line")
                if end_row != row:
                    self.fail(row, "a key that spans lines is outside yaml_lite's "
                                   "subset")
                return self.mapping(row, col)
            if not self.rest_is_blank(end_row, end):
                self.fail(end_row, "unexpected text after a quoted scalar")
            return value, end_row + 1
        self.check_plain_start(row, col)
        text, end, kind = self.plain_line(row, col)
        if kind == "key":
            if ctx == "value":
                self.fail(row, "mapping values are not allowed here (a mapping "
                               "may not start on its key's line)")
            return self.mapping(row, col)
        if kind == "comment":
            return _plain_value(text, row + 1), row + 1
        text, next_row = self.plain_rest(row, text, parent)
        return _plain_value(text, row + 1), next_row

    def check_plain_start(self, row: int, col: int) -> None:
        line = self.lines[row]
        ch = line[col]
        nxt = line[col + 1] if col + 1 < len(line) else " "
        if ch in "&*":
            self.fail(row, "anchors and aliases are outside yaml_lite's subset")
        if ch == "!":
            self.fail(row, "tags are outside yaml_lite's subset")
        if ch == "?" and nxt in " \t":
            self.fail(row, "complex keys ('? ') are outside yaml_lite's subset")
        if ch == ":" and nxt in " \t":
            self.fail(row, "an empty key is outside yaml_lite's subset")
        if ch == "\t":
            self.fail(row, "a tab where YAML allows only spaces")
        if ch in _NO_PLAIN_START or (ch == "-" and nxt in " \t"):
            self.fail(row, f"a plain scalar may not start with {ch!r}")

    def skip_spaces(self, row: int, col: int) -> int:
        line = self.lines[row]
        while col < len(line) and line[col] == " ":
            col += 1
        return col

    # ---------------------------------------------------- collections
    def mapping(self, row: int, col: int) -> Tuple[dict, int]:
        out = {}
        while True:
            key, vcol = self.key(row, col)
            if self.rest_is_blank(row, vcol):
                nxt = self.skip(row + 1)
                if nxt < self.n and self.marker(nxt) is None:
                    ind = self.indent(nxt)
                    if ind > col:
                        value, nxt = self.node(nxt, ind, col, "line")
                    elif ind == col and self.is_entry(nxt, col):
                        value, nxt = self.sequence(nxt, col)
                    elif ind == col and self.lines[nxt][ind] in "|>":
                        value, nxt = self.block_scalar(nxt, ind, col)
                    else:
                        value = None
                else:
                    value = None
            else:
                value, nxt = self.node(row, self.skip_spaces(row, vcol), col, "value")
            out[key] = value
            row = self.skip(nxt)
            if row >= self.n or self.marker(row) is not None:
                return out, row
            ind = self.indent(row)
            if ind < col:
                return out, row
            if ind > col:
                self.fail(row, "unexpected indentation in a block mapping")
            if self.is_entry(row, col):
                self.fail(row, "expected a mapping key, found a sequence entry")

    def key(self, row: int, col: int) -> Tuple[Any, int]:
        """A simple key at (row, col): (its value, the column after ``:``)."""
        line = self.lines[row]
        ch = line[col]
        if ch in "'\"":
            value, end_row, end = self.quoted(row, col)
            after = self.skip_spaces(end_row, end)
            if end_row != row or not self.value_after(row, after):
                self.fail(row, "could not find the ':' of a mapping key")
            return value, after + 1
        if ch in "[{":
            self.fail(row, "a flow collection as a key is outside yaml_lite's subset")
        self.check_plain_start(row, col)
        text, end, kind = self.plain_line(row, col)
        if kind != "key":
            self.fail(row, "could not find the ':' of a mapping key")
        if _tag_of(text) == "merge":
            self.fail(row, "merge keys ('<<') are outside yaml_lite's subset")
        return _plain_value(text, row + 1, key=True), end + 1

    def sequence(self, row: int, col: int) -> Tuple[list, int]:
        out = []
        while True:
            c = self.skip_spaces(row, col + 1)
            if self.rest_is_blank(row, c):
                nxt = self.skip(row + 1)
                ind = self.indent(nxt) if nxt < self.n and self.marker(nxt) is None else -1
                if ind > col:
                    value, nxt = self.node(nxt, ind, col, "line")
                elif ind == col and self.lines[nxt][ind] in "|>":
                    value, nxt = self.block_scalar(nxt, ind, col)
                else:
                    value = None
            else:
                value, nxt = self.node(row, c, col, "entry")
            out.append(value)
            row = self.skip(nxt)
            if row >= self.n or self.marker(row) is not None:
                return out, row
            ind = self.indent(row)
            if ind > col:
                self.fail(row, "unexpected indentation in a block sequence")
            if ind < col or not self.is_entry(row, col):
                return out, row

    # --------------------------------------------------------- scalars
    def plain_line(self, row: int, col: int, flow: bool = False) -> Tuple[str, int, str]:
        """A plain scalar's text on one line from ``col``: (text, the column
        where it stopped, why: "key" at a ``:`` indicator, "comment", "end"
        of the line, or "flow" at a flow indicator)."""
        line = self.lines[row]
        i = end = col
        n = len(line)
        while i < n:
            ch = line[i]
            if ch == "\t":
                self.fail(row, "a tab outside a quoted or block scalar")
            if ch == " ":
                j = self.skip_spaces(row, i)
                if j < n and line[j] == "#":
                    return line[col:end], end, "comment"
                if j < n and line[j] == "\t":
                    self.fail(row, "a tab outside a quoted or block scalar")
                i = j
                continue
            if ch == ":":
                nxt = line[i + 1] if i + 1 < n else " "
                if nxt in " \t" or (flow and nxt in _FLOW_END):
                    if nxt == "\t":
                        self.fail(row, "a tab where YAML allows only spaces")
                    return line[col:end], i, "key"
            if flow and ch in _FLOW_END:
                return line[col:end], i, "flow"
            if flow and ch == "?":
                self.fail(row, "'?' in a flow collection is outside yaml_lite's subset")
            i += 1
            end = i
        return line[col:end], end, "end"

    def plain_rest(self, row: int, text: str, parent: int) -> Tuple[str, int]:
        """Fold the continuation lines of a plain scalar whose first line
        ended at its line's end: lines indented deeper than ``parent``; one
        line break reads as a space, n + 1 as n newlines."""
        chunks = [text]
        r = row + 1
        blanks = 0
        while r < self.n:
            if self.marker(r) is not None:
                break
            line = self.lines[r]
            ind = self.indent(r)
            if ind == len(line):
                blanks += 1
                r += 1
                continue
            if ind <= parent or line[ind] == "#":
                break
            more, _, kind = self.plain_line(r, ind)
            if kind == "key":
                self.fail(r, "mapping values are not allowed here (a key after "
                             "a multi-line plain scalar)")
            chunks.append("\n" * blanks if blanks else " ")
            chunks.append(more)
            blanks = 0
            r += 1
            if kind == "comment":
                break
        return "".join(chunks), r

    def quoted(self, row: int, col: int) -> Tuple[str, int, int]:
        """A single- or double-quoted scalar from its opening quote: (value,
        row, the column after its closing quote)."""
        quote = self.lines[row][col]
        double = quote == '"'
        chunks: List[str] = []
        r, i = row, col + 1
        while True:
            line = self.lines[r]
            n = len(line)
            escaped_break = False
            while i < n:
                ch = line[i]
                if ch == quote:
                    if not double and i + 1 < n and line[i + 1] == "'":
                        chunks.append("'")
                        i += 2
                        continue
                    return "".join(chunks), r, i + 1
                if double and ch == "\\":
                    if i + 1 == n:
                        escaped_break = True
                        break
                    e = line[i + 1]
                    if e in _ESCAPES:
                        chunks.append(_ESCAPES[e])
                        i += 2
                    elif e in _HEX_ESCAPES:
                        k = _HEX_ESCAPES[e]
                        digits = line[i + 2:i + 2 + k]
                        if len(digits) != k or not all(c in "0123456789abcdefABCDEF"
                                                       for c in digits):
                            self.fail(r, f"expected {k} hex digits after \\{e}")
                        chunks.append(chr(int(digits, 16)))
                        i += 2 + k
                    else:
                        self.fail(r, f"unknown escape \\{e} in a double-quoted scalar")
                    continue
                if ch in " \t":
                    j = i
                    while j < n and line[j] in " \t":
                        j += 1
                    if j < n:
                        chunks.append(line[i:j])
                    i = j
                    continue
                j = i + 1
                while j < n and line[j] not in " \t\\'\"":
                    j += 1
                chunks.append(line[i:j])
                i = j
            # the line ends inside the quotes
            if r + 1 >= self.n:
                self.fail(r, "the stream ends inside a quoted scalar")
            blanks = 0
            r += 1
            while True:
                if self.marker(r) is not None:
                    self.fail(r, "a document marker inside a quoted scalar")
                line = self.lines[r]
                i = len(line) - len(line.lstrip(" \t"))
                if i < len(line) or r + 1 >= self.n:
                    break
                blanks += 1
                r += 1
            if i == len(self.lines[r]) and r + 1 >= self.n:
                self.fail(r, "the stream ends inside a quoted scalar")
            if escaped_break:
                chunks.append("\n" * blanks)
            else:
                chunks.append("\n" * blanks if blanks else " ")

    def block_scalar(self, row: int, col: int, parent: int) -> Tuple[str, int]:
        """A literal (``|``) or folded (``>``) scalar; its header at (row, col)."""
        line = self.lines[row]
        folded = line[col] == ">"
        chomp, step = None, None
        i = col + 1
        for _ in range(2):
            if i < len(line) and line[i] in "+-" and chomp is None:
                chomp = line[i] == "+"
                i += 1
            elif i < len(line) and line[i].isdigit() and step is None:
                step = int(line[i])
                if step == 0:
                    self.fail(row, "a block scalar's indentation digit is 1 to 9")
                i += 1
        if i < len(line) and line[i] not in " \t":
            self.fail(row, f"unexpected {line[i]!r} in a block scalar's header")
        if not self.rest_is_blank(row, i):
            self.fail(row, "unexpected text after a block scalar's header")
        low = max(parent + 1, 1)
        r = row + 1
        if step is None:
            breaks, width, c = 0, 0, 0
            while r < self.n:
                text = self.lines[r]
                c = len(text) - len(text.lstrip(" "))
                width = max(width, c)
                if c < len(text) or r + 1 >= self.n:
                    break
                breaks += 1
                r += 1
            indent = max(low, width)
        else:
            indent = low + step - 1
            breaks, r, c = self.block_breaks(r, indent)
        chunks: List[str] = []
        line_break = ""
        while r < self.n and c == indent and not self.eof(r, c):
            chunks.append("\n" * breaks)
            text = self.lines[r]
            leading_non_space = text[indent] not in " \t"
            chunks.append(text[indent:])
            if r + 1 >= self.n:
                line_break, r, breaks = "", self.n, 0
                break
            line_break = "\n"
            breaks, r, c = self.block_breaks(r + 1, indent)
            if c == indent and not self.eof(r, c):
                if folded and leading_non_space and self.lines[r][indent] not in " \t":
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomp is not False:
            chunks.append(line_break)
        if chomp is True:
            chunks.append("\n" * breaks)
        return "".join(chunks), r

    def block_breaks(self, r: int, indent: int) -> Tuple[int, int, int]:
        """Skip up to ``indent`` spaces of each line from row ``r``, counting
        the lines that end there: (count, row, column where it stopped)."""
        breaks = 0
        while r < self.n:
            text = self.lines[r]
            c = min(len(text) - len(text.lstrip(" ")), indent)
            if c == len(text) and r + 1 < self.n:
                breaks += 1
                r += 1
                continue
            return breaks, r, c
        return breaks, r, 0

    def flow(self, row: int, col: int) -> Tuple[Any, int]:
        """A flow collection that closes on its line: (value, the column
        after it)."""
        line = self.lines[row]
        close = "]" if line[col] == "[" else "}"
        out: Any = [] if close == "]" else {}
        i = col + 1
        while True:
            i = self.flow_space(row, i)
            if line[i] == close:
                return out, i + 1
            key, i = self.flow_item(row, i)
            i = self.flow_space(row, i)
            if close == "]":
                if self.value_after(row, i) or (line[i] == ":" and i + 1 < len(line)
                                                and line[i + 1] in _FLOW_END):
                    self.fail(row, "a mapping inside a flow sequence is outside "
                                   "yaml_lite's subset")
                out.append(key)
            else:
                if isinstance(key, (list, dict)):
                    self.fail(row, "a flow collection as a key is outside "
                                   "yaml_lite's subset")
                value = None
                if line[i] == ":":
                    i = self.flow_space(row, i + 1)
                    if line[i] not in ",}":
                        value, i = self.flow_item(row, i)
                        i = self.flow_space(row, i)
                out[key] = value
            if line[i] == ",":
                i += 1
            elif line[i] != close:
                self.fail(row, f"expected ',' or {close!r} in a flow collection")

    def flow_space(self, row: int, i: int) -> int:
        line = self.lines[row]
        while i < len(line) and line[i] == " ":
            i += 1
        if i >= len(line) or line[i] == "#" and line[i - 1] == " ":
            self.fail(row, "a flow collection that does not close on its line is "
                           "outside yaml_lite's subset")
        if line[i] == "\t":
            self.fail(row, "a tab where YAML allows only spaces")
        return i

    def flow_item(self, row: int, i: int) -> Tuple[Any, int]:
        line = self.lines[row]
        ch = line[i]
        if ch in "[{":
            return self.flow(row, i)
        if ch in "'\"":
            value, end_row, end = self.quoted(row, i)
            if end_row != row:
                self.fail(row, "a flow collection that does not close on its line "
                               "is outside yaml_lite's subset")
            return value, end
        self.check_plain_start(row, i)
        text, end, kind = self.plain_line(row, i, flow=True)
        if kind in ("comment", "end"):
            self.fail(row, "a flow collection that does not close on its line is "
                           "outside yaml_lite's subset")
        return _plain_value(text, row + 1), end


def _text_of(stream) -> str:
    text = stream.read() if hasattr(stream, "read") else stream
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    return text


def safe_load_all(stream) -> Iterator[Any]:
    """Each document of ``stream`` (text, bytes or a file), as
    ``yaml.safe_load_all`` returns them."""
    return _Reader(_text_of(stream)).documents()


def safe_load(stream) -> Any:
    """The one document of ``stream``, or None for an empty stream, as
    ``yaml.safe_load`` returns it."""
    reader = _Reader(_text_of(stream))
    docs = reader.documents()
    first = next(docs, None)
    for _ in docs:
        raise YAMLError(0, "expected a single document in the stream, but found "
                           "another document")
    return first


# ---------------------------------------------------------------- writer
_WIDTH = 80
_STEP = 2
_TAG_NAMES = {type(None): "null", bool: "bool", int: "int", float: "float", str: "str",
              datetime.date: "timestamp"}
_BREAKS = "\n\x85\u2028\u2029"
_SPACE_OR_BREAK = "\0 \t\r\n\x85\u2028\u2029"
_WRITE_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n",
                  "\x0b": "v", "\x0c": "f", "\r": "r", "\x1b": "e", '"': '"',
                  "\\": "\\", "\x85": "N", "\xa0": "_", "\u2028": "L",
                  "\u2029": "P"}


def _styles(text: str) -> Tuple[bool, bool, bool]:
    """(plain allowed in block context, single quotes allowed, spans lines)
    for a string, by the characters PyYAML's writer looks at."""
    if not text:
        return True, True, False
    indicators = text.startswith(("---", "..."))
    breaks = special = False
    leading = text[0] == " " or text[0] in _BREAKS
    trailing = text[-1] == " " or text[-1] in _BREAKS
    space_break = break_space = False
    after_space = after_break = False
    before_ws = True
    n = len(text)
    for i, ch in enumerate(text):
        after_ws = i + 1 >= n or text[i + 1] in _SPACE_OR_BREAK
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and after_ws):
                indicators = True
        elif (ch == ":" and after_ws) or (ch == "#" and before_ws):
            indicators = True
        if ch in _BREAKS:
            breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7e"):
            special = True      # non-ASCII is escaped (PyYAML's allow_unicode=False)
        if ch == " ":
            break_space = break_space or after_break
            after_space, after_break = True, False
        elif ch in _BREAKS:
            space_break = space_break or after_space
            after_space, after_break = False, True
        else:
            after_space = after_break = False
        before_ws = ch in _SPACE_OR_BREAK
    plain = not (leading or trailing or break_space or space_break or special
                 or breaks or indicators)
    single = not (break_space or space_break or special)
    return plain, single, breaks


class _Writer:
    """One document in PyYAML's block style. ``column``, ``whitespace`` (the
    last character written was a space or a break) and ``indention`` (only
    indentation is on the current line) decide where breaks and spaces go,
    as in PyYAML's emitter."""

    def __init__(self):
        self.parts: List[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent: Optional[int] = None
        self.open_ended = False
        self.seen = set()

    def write(self, text: str) -> None:
        self.parts.append(text)
        self.column += len(text)

    def line_break(self) -> None:
        self.parts.append("\n")
        self.column = 0
        self.whitespace = self.indention = True

    def to_indent(self) -> None:
        indent = self.indent or 0
        if not self.indention or self.column > indent or \
                (self.column == indent and not self.whitespace):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def indicator(self, text: str, need_space: bool, whitespace: bool = False,
                  indention: bool = False) -> None:
        self.write(text if self.whitespace or not need_space else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False

    def deeper(self, flow: bool = False, indentless: bool = False) -> Optional[int]:
        saved = self.indent
        if self.indent is None:
            self.indent = _STEP if flow else 0
        elif not indentless:
            self.indent += _STEP
        return saved

    # ------------------------------------------------------------ nodes
    def document(self, value: Any) -> str:
        self.node(value, root=True)
        self.to_indent()
        if self.open_ended:
            self.indicator("...", True)
            self.to_indent()
        return "".join(self.parts)

    def node(self, value: Any, root: bool = False, in_mapping: bool = False,
             key: bool = False) -> None:
        kind = type(value)
        if kind in (list, tuple, dict, datetime.date) and value != ():
            if id(value) in self.seen:
                raise YAMLError(0, "one object reached twice needs an anchor, "
                                   "which yaml_lite does not write")
            self.seen.add(id(value))
        if kind in (list, tuple, dict):
            if key:
                raise YAMLError(0, "a collection as a key is outside yaml_lite's "
                                   "subset")
            if not value:
                self.indicator("[" if kind is not dict else "{", True, whitespace=True)
                self.indicator("]" if kind is not dict else "}", False)
            elif kind is dict:
                self.mapping(value)
            else:
                self.sequence(value, in_mapping)
            return
        self.scalar(value, root, key)

    def sequence(self, items, in_mapping: bool) -> None:
        saved = self.deeper(indentless=in_mapping and not self.indention)
        for item in items:
            self.to_indent()
            self.indicator("-", True, indention=True)
            self.node(item)
        self.indent = saved

    def mapping(self, items: dict) -> None:
        saved = self.deeper()
        for k, v in items.items():
            self.to_indent()
            self.node(k, in_mapping=True, key=True)
            self.indicator(":", False)
            self.node(v, in_mapping=True)
        self.indent = saved

    def scalar(self, value: Any, root: bool, key: bool) -> None:
        kind = type(value)
        text, resolves = _scalar_text(value), True
        if kind is str:
            resolves = _tag_of(text) == "str"
        plain, single, multiline = _styles(text)
        # PyYAML counts the key's tag ("!!str") with its text against 128
        if key and (not text or multiline or
                    len(text) + len(_TAG_NAMES[kind]) + 2 >= 128):
            raise YAMLError(0, f"the key {text!r} needs YAML's complex-key form, "
                               "which yaml_lite does not write")
        saved = self.deeper(flow=True)
        split = not key
        if resolves and plain:
            self.plain(text, split, root)
        elif single:
            self.single_quoted(text, split)
        else:
            self.double_quoted(text, split)
        self.indent = saved

    # ---------------------------------------------------------- scalars
    def plain(self, text: str, split: bool, root: bool) -> None:
        if root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        for piece in re.split("( +)", text):
            if piece == " " and split and self.column > _WIDTH:
                self.to_indent()        # fold at a single space past the width
                self.whitespace = self.indention = False
            else:
                self.write(piece)

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        pos = 0
        for piece in re.split("( +|\n+)", text):
            if not piece:
                continue
            end = pos + len(piece)
            if piece[0] == " ":
                if piece == " " and split and self.column > _WIDTH and pos and \
                        end != len(text):
                    self.to_indent()
                else:
                    self.write(piece)
            elif piece[0] == "\n":
                # n breaks are written as n + 1: one line break folds to a space
                for _ in range(len(piece) + 1):
                    self.line_break()
                self.to_indent()
            else:
                self.write(piece.replace("'", "''"))
            pos = end
        self.indicator("'", False)

    def double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        n = len(text)
        start = 0
        for end in range(n + 1):
            ch = text[end] if end < n else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or \
                    not "\x20" <= ch <= "\x7e":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    self.write("\\" + _escape(ch))
                    start = end + 1
            # Fold with an escaped line break where the line passed the width:
            # at a space, or right after an escape.
            if 0 < end < n - 1 and (ch == " " or start >= end) and \
                    self.column + (end - start) > _WIDTH and split:
                self.write(text[start:end] + "\\")
                start = max(start, end)
                self.to_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
        self.indicator('"', False)


def _escape(ch: str) -> str:
    if ch in _WRITE_ESCAPES:
        return _WRITE_ESCAPES[ch]
    code = ord(ch)
    if code <= 0xFF:
        return "x%02X" % code
    if code <= 0xFFFF:
        return "u%04X" % code
    return "U%08X" % code


def _scalar_text(value: Any) -> str:
    kind = type(value)
    if value is None:
        return "null"
    if kind is bool:
        return "true" if value else "false"
    if kind is int:
        return str(value)
    if kind is float:
        if value != value:
            return ".nan"
        if value in (math.inf, -math.inf):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        # repr(1e17) is '1e+17', which YAML 1.1 does not read as a float
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if kind is str:
        return value
    if kind is datetime.date:
        return value.isoformat()
    raise YAMLError(0, f"yaml_lite does not write a {kind.__name__}")


def safe_dump(value: Any) -> str:
    """``yaml.safe_dump(value, default_flow_style=False, sort_keys=False)``."""
    return _Writer().document(value)
