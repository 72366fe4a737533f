// Native issue-report normalizer.
//
// C++17 implementation of the ordered tag-replacement passes in
// memvul_tpu_torch/data/normalize.py (behavior-parity with the reference
// normalizer, MemVul/util.py:39-142).  The Python pass table is the
// specification; this library exists because normalization is the
// host-side hot path when preprocessing the 1.2M-report corpus — the
// batch entry point fans documents out over a thread pool, and the
// Python binding (memvul_tpu_torch/data/native.py) only enables it after a
// runtime parity self-check against the Python implementation.
//
// Error contract: any per-document failure (regex engine limits,
// oversized input) returns NULL for that document and the Python side
// falls back to the pure-Python pass table, so the native path can never
// produce a wrong result silently — only a slower one.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread normalizer.cpp
//        -o build/native/libmemvul_native_<hash>.so
//        (memvul_tpu_torch/data/native.py builds it at first use)

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdlib>
#include <cstring>
#include <pthread.h>
#include <regex>
#include <string>
#include <thread>
#include <vector>

namespace {

using std::regex;
using std::regex_constants::icase;
using std::string;

// libstdc++'s std::regex executor recurses per matched character for
// quantified alternations (kUrl, kApiCatchall); large documents can
// overflow the thread stack, which catch(...) cannot intercept.  The
// single-document entry runs on the CALLER's thread (stack size unknown,
// typically 8MB) so it keeps a conservative 16KB cap; the batch entry
// creates its own pool threads with 64MB stacks, which safely covers
// 256KB documents (≈256K frames × ~128B ≪ 64MB) — issue bodies with
// large pasted logs stay on the fast path there.
constexpr size_t kMaxDocBytesCallerStack = 16 << 10;
constexpr size_t kMaxDocBytesPoolStack = 256 << 10;
constexpr size_t kPoolThreadStackBytes = 64ull << 20;
constexpr size_t kMaxApiSpan = 150;       // normalize.py _MAX_API_SPAN

// ---------------------------------------------------------------------------
// pass-table regexes (compiled once; ECMAScript grammar).  Python's `.`
// with re.S becomes [\s\S]; everything else is shared syntax.
// ---------------------------------------------------------------------------

// Python's '.' (no re.S) excludes only \n; ECMAScript '.' also excludes
// \r/ /  — use [^\n] explicitly so comments containing a bare
// carriage return normalize identically on both paths
const regex kCommentLine("<!---[^\\n]*?-->");

const regex kErrorish(
    "exception|error|warning|404|can't|can\\s?not|could\\s?not|un[a-z]{3,}",
    icase);
const regex kProse(
    "^yaml|^\\s*([a-z]+[,\\.\\?]?\\s+)*?[a-z]+[,\\.\\?]?\\s*$", icase);
const regex kOneToken("^\\s*\\S+\\s*$");

const regex kMdLink("!?\\[([\\s\\S]+?)\\]\\((\\S+)\\)");
const regex kUrl(
    "http[s]?://(?:[a-zA-Z]|[0-9]|[$-_@.&+#]|[!*\\(\\),]|(?:%[0-9a-fA-F][0-9a-"
    "fA-F]))+");
const regex kVulnTracker("bugzilla|mitre|bugs", icase);

const regex kAngleRun("<[^>]*>{2,}");
const regex kAngleAttr("<[^>]*?[!;=/$%][^>]*>");

const regex kEscapedPairs(
    "(\\\\r\\\\n)|(\\\\n\\\\n)|(\\\\r\\\\r)|(\\\\t\\\\t)|(\\\\\")|(\\\\')");
const regex kStars("\\*{1,}");
const regex kHashes("#{1,}");
const regex kCve("CVE-[0-9]+-[0-9]+");
const regex kCwe("CWE-[0-9]+");
const regex kEmail("[0-9a-zA-Z_]{0,19}@[0-9a-zA-Z]{1,13}\\.[com,cn,net]{1,3}");
const regex kMention("@[a-zA-Z0-9_\\-]+[,\\.]?\\s");
const regex kError(
    "\\S+?(Error|Exception)([^A-Za-z\\s]\\S*|\\s|$)|404");
const regex kPath("([^\\s\\(\\)]+?[/\\\\]){2,}[^\\s\\(\\)]*");

const regex kFileExt(
    "\\s(\\S+?\\.(ml|xml|png|csv|jar|sh|sbt|zip|exe|md|txt|js|yml|yaml|json|"
    "sql|html|pdf|jsp|php|prod|scss|ts|jpg|png|bmp|gif))[?,\\.]{0,1}\\s",
    icase);

const regex kDash("-");
const regex kLongToken("\\S{30,}");
const regex kApiCatchall(
    "\\S+?((\\(\\))|(\\[\\]))\\S*|[^,;\\.\\s]{3,}?\\.\\S{4,}|"
    "\\S+?([a-z][A-Z]|[A-Z][a-z]{2,}?)\\S*|@\\S+|<\\S*?>");
const regex kNumber(
    "[^a-uwyz]+?\\d[^a-uwyz]*(beta[0-9]+){0,1}|beta[0-9]+", icase);
const regex kCtrlChars("[\\r\\n\\t]");
const regex kEscapedSingles("(\\\\r)|(\\\\n)|(\\\\t)|(\\\\\")|(\\\\')");

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

string sub_all(const regex& re, const string& repl, const string& s) {
  return std::regex_replace(s, re, repl);
}

void replace_first(string* s, const string& needle, const string& repl) {
  size_t pos = s->find(needle);
  if (pos != string::npos) s->replace(pos, needle.size(), repl);
}

// Python: re.search(r"\.", s[-5:-1])
bool looks_like_file(const string& s) {
  if (s.size() < 2) return false;
  size_t start = s.size() >= 5 ? s.size() - 5 : 0;
  size_t end = s.size() - 1;  // exclusive
  for (size_t i = start; i < end; ++i)
    if (s[i] == '.') return true;
  return false;
}

// normalize.py _classify_code_span
string classify_code_span(const string& inner) {
  if (inner.empty()) return " ";
  if (std::regex_search(inner, kErrorish)) return " ERRORTAG ";
  if (std::regex_search(inner, kProse)) return " " + inner + " ";
  if (std::regex_search(inner, kOneToken) || inner.size() <= kMaxApiSpan)
    return " APITAG ";
  return " CODETAG ";
}

// normalize.py _rewrite_code_spans: matches collected on the ORIGINAL
// string (lazy, non-overlapping), then sequential first-occurrence
// replacement — the fence finder is hand-rolled (equivalent to
// `fence[\s\S]*?fence`) to avoid regex backtracking on big code blocks.
string rewrite_code_spans(string content, const string& fence) {
  std::vector<string> spans;
  size_t pos = 0;
  const size_t n = fence.size();
  while (true) {
    size_t a = content.find(fence, pos);
    if (a == string::npos) break;
    size_t b = content.find(fence, a + n);
    if (b == string::npos) break;
    spans.push_back(content.substr(a, b + n - a));
    pos = b + n;
  }
  for (const string& span : spans) {
    string inner = span.substr(n, span.size() - 2 * n);
    replace_first(&content, span, classify_code_span(inner));
  }
  return content;
}

string rewrite_md_links(string content) {
  std::vector<std::array<string, 3>> matches;  // whole, text, target
  for (auto it = std::sregex_iterator(content.begin(), content.end(), kMdLink);
       it != std::sregex_iterator(); ++it)
    matches.push_back({it->str(0), it->str(1), it->str(2)});
  for (const auto& m : matches) {
    if (looks_like_file(m[1]) || looks_like_file(m[2]))
      replace_first(&content, m[0], " FILETAG ");
    else
      replace_first(&content, m[0], " " + m[1] + " " + m[2] + " ");
  }
  return content;
}

string rewrite_urls(string content) {
  std::vector<string> urls;
  for (auto it = std::sregex_iterator(content.begin(), content.end(), kUrl);
       it != std::sregex_iterator(); ++it)
    urls.push_back(it->str(0));
  for (const string& url : urls) {
    string repl;
    if (std::regex_search(url, kVulnTracker))
      repl = " CVETAG ";  // cve.mitre.org / bugzilla — leak guard
    else if (looks_like_file(url))
      repl = " FILETAG ";
    else
      repl = " URLTAG ";
    replace_first(&content, url, repl);
  }
  return content;
}

string rewrite_filenames(string content) {
  std::vector<string> names;
  for (auto it =
           std::sregex_iterator(content.begin(), content.end(), kFileExt);
       it != std::sregex_iterator(); ++it)
    names.push_back(it->str(1));
  for (const string& name : names) replace_first(&content, name, " FILETAG ");
  return content;
}

string collapse_spaces(const string& s) {
  // " ".join(tok for tok in content.split(" ") if tok)
  string out;
  out.reserve(s.size());
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && s[i] == ' ') ++i;
    size_t start = i;
    while (i < s.size() && s[i] != ' ') ++i;
    if (i > start) {
      if (!out.empty()) out += ' ';
      out.append(s, start, i - start);
    }
  }
  return out;
}

string normalize_one(const string& input) {
  string content = sub_all(kCommentLine, " ", input);
  content = rewrite_code_spans(content, "```");
  content = rewrite_code_spans(content, "`");
  content = rewrite_md_links(content);
  content = sub_all(kAngleRun, " APITAG ", content);
  content = sub_all(kAngleAttr, " APITAG ", content);
  content = rewrite_urls(content);
  content = sub_all(kEscapedPairs, " ", content);
  content = sub_all(kStars, " ", content);
  content = sub_all(kHashes, " ", content);
  content = sub_all(kCve, " CVETAG ", content);
  content = sub_all(kCwe, " CVETAG ", content);
  content = sub_all(kEmail, " EMAILTAG ", content);
  content = sub_all(kMention, " MENTIONTAG ", content);
  content = sub_all(kError, " ERRORTAG ", content);
  content = sub_all(kPath, " PATHTAG ", content);
  content = rewrite_filenames(content);
  content = sub_all(kDash, " ", content);
  content = sub_all(kLongToken, " APITAG ", content);
  content = sub_all(kApiCatchall, " APITAG ", content);
  content = sub_all(kNumber, " NUMBERTAG ", content);
  content = sub_all(kCtrlChars, " ", content);
  content = sub_all(kEscapedSingles, " ", content);
  return collapse_spaces(content);
}

char* normalize_or_null(const char* text, size_t max_bytes) {
  if (text == nullptr) return nullptr;
  size_t len = std::strlen(text);
  if (len > max_bytes) return nullptr;  // caller falls back to Python
  // non-ASCII documents fall back: byte-oriented std::regex disagrees
  // with Python's unicode-aware \s/\w on e.g. U+00A0, and correctness
  // beats speed by contract
  for (size_t i = 0; i < len; ++i)
    if (static_cast<unsigned char>(text[i]) >= 0x80) return nullptr;
  try {
    string out = normalize_one(string(text, len));
    char* buf = static_cast<char*>(std::malloc(out.size() + 1));
    if (buf == nullptr) return nullptr;
    std::memcpy(buf, out.c_str(), out.size() + 1);
    return buf;
  } catch (...) {
    return nullptr;  // regex limits etc. — caller falls back
  }
}

}  // namespace

extern "C" {

// One document. Returns a malloc'd NUL-terminated string (free with
// mv_free) or NULL when the caller should use the Python fallback.
// Runs on the caller's thread, so only small documents are accepted.
char* mv_normalize(const char* text) {
  return normalize_or_null(text, kMaxDocBytesCallerStack);
}

void mv_free(char* p) { std::free(p); }

namespace {

struct BatchJob {
  const char** texts;
  char** out;
  int n;
  std::atomic<int>* next;
  size_t max_bytes;  // pool threads: 256KB; inline fallback: 16KB
};

void* batch_worker(void* arg) {
  auto* job = static_cast<BatchJob*>(arg);
  while (true) {
    int i = job->next->fetch_add(1);
    if (i >= job->n) break;
    job->out[i] = normalize_or_null(job->texts[i], job->max_bytes);
  }
  return nullptr;
}

}  // namespace

// Batch over a thread pool: out[i] receives the normalization of
// texts[i].  Each out[i] must be released with mv_free (NULL entries
// mean Python fallback).  Pool threads get 64MB stacks so documents up
// to kMaxDocBytesPoolStack survive std::regex recursion.
void mv_normalize_batch(const char** texts, int n, char** out,
                        int n_threads) {
  if (n <= 0) return;
  int workers = std::max(1, n_threads);
  workers = std::min(workers, n);
  std::atomic<int> next{0};
  BatchJob job{texts, out, n, &next, kMaxDocBytesPoolStack};
  pthread_attr_t attr;
  pthread_attr_init(&attr);
  pthread_attr_setstacksize(&attr, kPoolThreadStackBytes);
  std::vector<pthread_t> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pthread_t th;
    if (pthread_create(&th, &attr, batch_worker, &job) == 0) {
      pool.push_back(th);
    }
  }
  pthread_attr_destroy(&attr);
  if (pool.empty()) {
    // thread creation failed — run inline on the CALLER's stack, so only
    // caller-stack-safe document sizes may take the native path
    job.max_bytes = kMaxDocBytesCallerStack;
    batch_worker(&job);
  }
  for (pthread_t th : pool) pthread_join(th, nullptr);
}

int mv_abi_version() { return 1; }

}  // extern "C"
