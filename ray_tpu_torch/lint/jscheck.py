"""Minimal ECMAScript tokenizer for typo-class syntax gating.

The dashboard SPA (`dashboard/app.html`) ships as inline `<script>`
blocks that no tier-1 test ever executes — a stray brace or an
unterminated template literal would only surface as a blank dashboard
in production (VERDICT Weak #7).  This is NOT a parser: it tokenizes
far enough to catch the breakage class a typo produces —

- unbalanced / mismatched brackets `()[]{}`
- unterminated string, template literal, regex, or block comment

while understanding the constructs that defeat naive bracket counting:
comments, strings with escapes, template literals with nested `${}`
expressions, and regex literals (disambiguated from division by the
preceding token, the standard lexer heuristic).

`check_js(src)` returns a list of "line N: message" error strings
(empty when clean).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

_OPEN = {"(": ")", "[": "]", "{": "}"}
_CLOSE = {")": "(", "]": "[", "}": "{"}

# a `/` after one of these tokens starts a REGEX, not division
_REGEX_PRECEDERS = {
    "return", "typeof", "instanceof", "in", "of", "new", "case", "do",
    "else", "throw", "delete", "void", "yield", "await",
}

_PUNCT_CHARS = set("+-*/%=<>!&|^~?:;,.")


def _is_ident_char(c: str) -> bool:
    return c.isalnum() or c in "_$"


def check_js(src: str) -> List[str]:
    errors: List[str] = []
    # bracket stack entries: (char, line); template stack tracks the
    # ${ } nesting of template literals
    brackets: List[Tuple[str, int]] = []
    # mode stack: "tpl" = inside a template literal body; an entry is
    # pushed on `${` and the matching `}` returns to template mode
    tpl_stack: List[int] = []  # line where each open template began
    i = 0
    line = 1
    n = len(src)
    last_tok: Optional[str] = None  # last significant token (or kind)
    in_template = False

    def err(li: int, msg: str) -> None:
        errors.append(f"line {li}: {msg}")

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue

        # ---- inside a template literal body -------------------------
        if in_template:
            start_line = tpl_stack[-1]
            while i < n:
                c = src[i]
                if c == "\n":
                    line += 1
                    i += 1
                elif c == "\\":
                    i += 2
                elif c == "`":
                    tpl_stack.pop()
                    in_template = False
                    last_tok = "string"
                    i += 1
                    break
                elif c == "$" and i + 1 < n and src[i + 1] == "{":
                    brackets.append(("${", line))
                    in_template = False  # tokenize the expression
                    last_tok = None
                    i += 2
                    break
                else:
                    i += 1
            else:
                err(start_line, "unterminated template literal")
                return errors
            continue

        if c in " \t\r":
            i += 1
            continue

        # ---- comments -----------------------------------------------
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "*":
            start = line
            i += 2
            while i < n and not (src[i] == "*" and i + 1 < n
                                 and src[i + 1] == "/"):
                if src[i] == "\n":
                    line += 1
                i += 1
            if i >= n:
                err(start, "unterminated block comment")
                return errors
            i += 2
            continue

        # ---- strings ------------------------------------------------
        if c in "'\"":
            quote = c
            start = line
            i += 1
            while i < n:
                if src[i] == "\\":
                    if i + 1 < n and src[i + 1] == "\n":
                        line += 1  # legal line continuation
                    i += 2
                    continue
                if src[i] == "\n":
                    err(start, f"unterminated {quote} string")
                    line += 1
                    i += 1
                    break
                if src[i] == quote:
                    i += 1
                    break
                i += 1
            else:
                err(start, f"unterminated {quote} string")
                return errors
            last_tok = "string"
            continue

        # ---- template literal open ----------------------------------
        if c == "`":
            tpl_stack.append(line)
            in_template = True
            i += 1
            continue

        # ---- regex vs division --------------------------------------
        if c == "/":
            regex_ok = (
                last_tok is None
                or last_tok in _REGEX_PRECEDERS
                or last_tok in ("operator", "open")
            )
            if regex_ok:
                start = line
                i += 1
                in_class = False
                closed = False
                while i < n:
                    ch = src[i]
                    if ch == "\\":
                        i += 2
                        continue
                    if ch == "\n":
                        break  # regex literals cannot span lines
                    if ch == "[":
                        in_class = True
                    elif ch == "]":
                        in_class = False
                    elif ch == "/" and not in_class:
                        closed = True
                        i += 1
                        while i < n and _is_ident_char(src[i]):
                            i += 1  # flags
                        break
                    i += 1
                if not closed:
                    err(start, "unterminated regex literal")
                    return errors
                last_tok = "string"
                continue
            # division operator
            last_tok = "operator"
            i += 1
            continue

        # ---- brackets -----------------------------------------------
        if c in _OPEN:
            brackets.append((c, line))
            last_tok = "open"
            i += 1
            continue
        if c in _CLOSE:
            if not brackets:
                err(line, f"unmatched '{c}'")
                return errors
            opener, oline = brackets.pop()
            if c == "}" and opener == "${":
                in_template = True  # back into the template body
                i += 1
                continue
            if opener == "${":
                err(line, f"mismatched '{c}' closing template expression "
                          f"opened on line {oline}")
                return errors
            if opener != _CLOSE[c]:
                err(line, f"mismatched '{c}' (opened with '{opener}' on "
                          f"line {oline})")
                return errors
            last_tok = ")" if c == ")" else "value"
            i += 1
            continue

        # ---- identifiers / keywords ---------------------------------
        if _is_ident_char(c) and not c.isdigit():
            j = i
            while j < n and _is_ident_char(src[j]):
                j += 1
            word = src[i:j]
            last_tok = word if word in _REGEX_PRECEDERS else "value"
            i = j
            continue

        # ---- numbers ------------------------------------------------
        if c.isdigit():
            j = i
            while j < n and (_is_ident_char(src[j]) or src[j] == "."):
                j += 1
            last_tok = "value"
            i = j
            continue

        # ---- operators / punctuation --------------------------------
        if c in _PUNCT_CHARS:
            last_tok = "operator"
            i += 1
            continue

        # anything else (unicode, stray chars): treat as value
        last_tok = "value"
        i += 1

    if in_template and tpl_stack:
        err(tpl_stack[-1], "unterminated template literal")
    for opener, oline in brackets:
        err(oline, f"unclosed '{opener}'")
    return errors


def extract_scripts(html: str) -> List[Tuple[int, str]]:
    """-> [(start_line, script_source)] for every inline <script>
    block (src= scripts have no inline body worth checking)."""
    import re

    out: List[Tuple[int, str]] = []
    for m in re.finditer(
        r"<script(?![^>]*\bsrc\s*=)[^>]*>(.*?)</script>",
        html,
        re.DOTALL | re.IGNORECASE,
    ):
        start_line = html.count("\n", 0, m.start(1)) + 1
        out.append((start_line, m.group(1)))
    return out
