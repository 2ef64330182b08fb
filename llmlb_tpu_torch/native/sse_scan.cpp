// sse_scan: streaming SSE frame scanner for the proxy hot path.
//
// Native twin of gateway/token_accounting.py's line splitter (the reference's
// per-chunk SSE parse loop is Rust, api/proxy.rs:120-270). Feed raw bytes as
// they pass through; the scanner splits `data:` lines, counts frames, and
// extracts the last `"usage": {...}` object's prompt/completion token values
// with a targeted scan (no general JSON parse on the hot path). Content-text
// accumulation for the estimation fallback stays in Python — it only runs
// when an upstream omitted usage, off the hot path.

#include <cstdint>
#include <cstring>
#include <string>

namespace {

struct Scanner {
  std::string buffer;
  int64_t frames = 0;
  int64_t prompt_tokens = -1;
  int64_t completion_tokens = -1;

  static bool find_int_after(const std::string &s, const char *key,
                             size_t from, int64_t *out) {
    size_t k = s.find(key, from);
    if (k == std::string::npos)
      return false;
    size_t p = s.find(':', k + std::strlen(key));
    if (p == std::string::npos)
      return false;
    ++p;
    while (p < s.size() && (s[p] == ' ' || s[p] == '\t'))
      ++p;
    if (p >= s.size() || s[p] < '0' || s[p] > '9')
      return false;
    int64_t v = 0;
    while (p < s.size() && s[p] >= '0' && s[p] <= '9') {
      v = v * 10 + (s[p] - '0');
      ++p;
    }
    *out = v;
    return true;
  }

  void feed_line(const std::string &line) {
    size_t start = 0;
    while (start < line.size() &&
           (line[start] == ' ' || line[start] == '\r'))
      ++start;
    if (line.compare(start, 5, "data:") != 0)
      return;
    size_t ds = start + 5;
    while (ds < line.size() && line[ds] == ' ')
      ++ds;
    if (ds >= line.size())
      return;
    if (line.compare(ds, 6, "[DONE]") == 0)
      return;
    ++frames;
    size_t u = line.find("\"usage\"", ds);
    if (u == std::string::npos)
      return;
    int64_t pt, ct;
    bool got = false;
    if (find_int_after(line, "\"prompt_tokens\"", u, &pt)) {
      got = true;
    } else if (find_int_after(line, "\"input_tokens\"", u, &pt)) {
      got = true;
    } else {
      pt = -1;
    }
    if (find_int_after(line, "\"completion_tokens\"", u, &ct)) {
      got = true;
    } else if (find_int_after(line, "\"output_tokens\"", u, &ct)) {
      got = true;
    } else {
      ct = -1;
    }
    // only accept a usage object that reported something non-zero, matching
    // the Python accumulator's "usage != (0, 0)" rule
    if (got && (pt > 0 || ct > 0)) {
      prompt_tokens = pt < 0 ? 0 : pt;
      completion_tokens = ct < 0 ? 0 : ct;
    }
  }

  void feed(const uint8_t *data, size_t len) {
    buffer.append(reinterpret_cast<const char *>(data), len);
    size_t pos = 0;
    while (true) {
      size_t nl = buffer.find('\n', pos);
      if (nl == std::string::npos)
        break;
      feed_line(buffer.substr(pos, nl - pos));
      pos = nl + 1;
    }
    buffer.erase(0, pos);
  }
};

} // namespace

extern "C" {

void *sse_new() { return new Scanner(); }

void sse_feed(void *handle, const uint8_t *data, int64_t len) {
  static_cast<Scanner *>(handle)->feed(data, size_t(len));
}

int64_t sse_frames(void *handle) {
  return static_cast<Scanner *>(handle)->frames;
}

// Returns 1 if a usage object was captured; fills prompt/completion tokens.
int32_t sse_usage(void *handle, int64_t *prompt, int64_t *completion) {
  Scanner *s = static_cast<Scanner *>(handle);
  if (s->prompt_tokens < 0 && s->completion_tokens < 0)
    return 0;
  *prompt = s->prompt_tokens < 0 ? 0 : s->prompt_tokens;
  *completion = s->completion_tokens < 0 ? 0 : s->completion_tokens;
  return 1;
}

void sse_free(void *handle) { delete static_cast<Scanner *>(handle); }

} // extern "C"
