"""Issue-report text normalization (the JAX package's
``data/normalize.py``, its pure-Python pass table).

Replaces code blocks, links, identifiers, versions etc. with stable
placeholder tags (APITAG, CODETAG, ERRORTAG, FILETAG, URLTAG, CVETAG,
EMAILTAG, MENTIONTAG, PATHTAG, NUMBERTAG) so the encoder sees a bounded
vocabulary, with the leak guard that maps CVE-/CWE-identifiers and
mitre/bugzilla links to CVETAG.  Order of the passes is load-bearing:
paths are tagged before generic API tokens, CVE ids before the number
pass.  The JAX package's optional native normalizer is not ported.
"""

from __future__ import annotations

import re

# -- span classifiers --------------------------------------------------------

# error-ish text inside a code span ⇒ ERRORTAG
_ERRORISH = re.compile(
    r"exception|error|warning|404|can't|can\s?not|could\s?not|un[a-z]{3,}", re.I
)
# prose-like span (plain words, or yaml front-matter) ⇒ keep the inner text
_PROSE = re.compile(r"^yaml|^\s*([a-z]+[,\.\?]?\s+)*?[a-z]+[,\.\?]?\s*$", re.I)
# a single whitespace-free token ⇒ APITAG
_ONE_TOKEN = re.compile(r"^\s*\S+\s*$")

_MAX_API_SPAN = 150


def _classify_code_span(inner: str) -> str | None:
    """Decide the replacement for the *inner* text of a code span.

    Returns the replacement string (with surrounding spaces), or None when
    the whole span was empty and should collapse to a single space.
    """
    if inner == "":
        return None
    if _ERRORISH.search(inner):
        return " ERRORTAG "
    if _PROSE.search(inner):
        return f" {inner} "
    if _ONE_TOKEN.search(inner) or len(inner) <= _MAX_API_SPAN:
        return " APITAG "
    return " CODETAG "


def _rewrite_code_spans(content: str, fence: str) -> str:
    """Rewrite each ``fence``-delimited code span, one occurrence at a time."""
    n = len(fence)
    pattern = re.compile(re.escape(fence) + r".*?" + re.escape(fence), re.S)
    for match in pattern.finditer(content):
        span = match.group()
        replacement = _classify_code_span(span[n:-n]) or " "
        content = content.replace(span, replacement, 1)
    return content


# -- link / url handling -----------------------------------------------------

_MD_LINK = re.compile(r"[!]?\[(.+?)\]\((\S+)\)", re.S)
_URL = re.compile(
    r"http[s]?://(?:[a-zA-Z]|[0-9]|[$-_@.&+#]|[!*\(\),]|(?:%[0-9a-fA-F][0-9a-fA-F]))+"
)
_VULN_TRACKER = re.compile(r"bugzilla|mitre|bugs", re.I)


def _looks_like_file(s: str) -> bool:
    """A dot near the tail (chars -5..-2) suggests a file extension."""
    return bool(re.search(r"\.", s[-5:-1]))


def _rewrite_md_links(content: str) -> str:
    for match in _MD_LINK.finditer(content):
        whole, text, target = match.group(), match.group(1), match.group(2)
        if _looks_like_file(text) or _looks_like_file(target):
            content = content.replace(whole, " FILETAG ", 1)
        else:
            content = content.replace(whole, f" {text} {target} ", 1)
    return content


def _rewrite_urls(content: str) -> str:
    for match in _URL.finditer(content):
        url = match.group()
        if _VULN_TRACKER.search(url):
            # cve.mitre.org / cwe.mitre.org / bugzilla — vulnerability leak guard
            replacement = " CVETAG "
        elif _looks_like_file(url):
            replacement = " FILETAG "
        else:
            replacement = " URLTAG "
        content = content.replace(url, replacement, 1)
    return content


# -- filename pass -----------------------------------------------------------

_FILE_EXT = re.compile(
    r"\s(\S+?\.(ml|xml|png|csv|jar|sh|sbt|zip|exe|md|txt|js|yml|yaml|json|sql|"
    r"html|pdf|jsp|php|prod|scss|ts|jpg|png|bmp|gif))[?,\.]{0,1}\s",
    re.I,
)


def _rewrite_filenames(content: str) -> str:
    for match in _FILE_EXT.finditer(content):
        content = content.replace(match.group(1), " FILETAG ", 1)
    return content


# -- ordered regex passes ----------------------------------------------------

_SUB_PASSES = [
    # angle-bracket runs and attribute-ish html tags
    (re.compile(r"<[^>]*>{2,}"), " APITAG "),
    (re.compile(r"<[^>]*?[!;=/$%][^>]*>"), " APITAG "),
]

_POST_URL_PASSES = [
    # escaped-newline pairs and markdown emphasis/heading markers
    (re.compile(r"(\\r\\n)|(\\n\\n)|(\\r\\r)|(\\t\\t)|(\\\")|(\\\')"), " "),
    (re.compile(r"\*{1,}"), " "),
    (re.compile(r"#{1,}"), " "),
    # vulnerability identifiers — leak guard
    (re.compile(r"CVE-[0-9]+-[0-9]+"), " CVETAG "),
    (re.compile(r"CWE-[0-9]+"), " CVETAG "),
    (re.compile(r"[0-9a-zA-Z_]{0,19}@[0-9a-zA-Z]{1,13}\.[com,cn,net]{1,3}"), " EMAILTAG "),
    (re.compile(r"@[a-zA-Z0-9_\-]+[,\.]?\s"), " MENTIONTAG "),
    (re.compile(r"\S+?(Error|Exception)([^A-Za-z\s]\S*|\s|$)|404"), " ERRORTAG "),
    # multi-segment paths (2+ separators)
    (re.compile(r"([^\s\(\)]+?[/\\]){2,}[^\s\(\)]*"), " PATHTAG "),
]

_FINAL_PASSES = [
    (re.compile(r"-"), " "),
    (re.compile(r"\S{30,}"), " APITAG "),
    # call-sites, dotted identifiers, camelCase, mentions, generic tags
    (
        re.compile(
            r"\S+?((\(\))|(\[\]))\S*|[^,;\.\s]{3,}?\.\S{4,}|"
            r"\S+?([a-z][A-Z]|[A-Z][a-z]{2,}?)\S*|@\S+|<\S*?>"
        ),
        " APITAG ",
    ),
    (
        re.compile(r"[^a-uwyz]+?\d[^a-uwyz]*(beta[0-9]+){0,1}|beta[0-9]+", re.I),
        " NUMBERTAG ",
    ),
    (re.compile(r"[\r\n\t]"), " "),
    (re.compile(r"(\\r)|(\\n)|(\\t)|(\\\")|(\\\')"), " "),
]


def normalize_text(content) -> str:
    """Normalize one issue-report field (title or body) to tagged text."""
    if not isinstance(content, str):
        return ""

    content = re.sub(r"<!---.*?-->", " ", content)
    content = _rewrite_code_spans(content, "```")
    content = _rewrite_code_spans(content, "`")
    content = _rewrite_md_links(content)
    for pattern, repl in _SUB_PASSES:
        content = pattern.sub(repl, content)
    content = _rewrite_urls(content)
    for pattern, repl in _POST_URL_PASSES:
        content = pattern.sub(repl, content)
    content = _rewrite_filenames(content)
    for pattern, repl in _FINAL_PASSES:
        content = pattern.sub(repl, content)

    return " ".join(tok for tok in content.split(" ") if tok)


# reference-compatible alias (reference: MemVul/util.py:39)
replace_tokens_simple = normalize_text
