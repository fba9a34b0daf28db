// semmerge native frontend — C++ port of the host declaration scanner.
//
// A copy of the JAX package's native/semmerge_native.cpp, playing the
// role the Node.js TypeScript worker plays in the reference
// (reference workers/ts/src/{sast}.ts: parse + index): tokenize
// TypeScript/JavaScript source and index the five declaration kinds
// with the exact (symbolId, addressId) scheme of
// semantic_merge_tpu_torch/frontend/{tokenizer,scanner}.py. The Python
// scanner is the semantic oracle; this library must match it
// bit-for-bit on ASCII sources (non-ASCII snapshots fall back to
// Python host-side — offsets are code-point based there, byte based
// here).
//
// C ABI (consumed via ctypes from semantic_merge_tpu_torch/frontend/native.py):
//   char* smn_scan_snapshot(const char** paths, const char** contents,
//                           int n_files)
//     → malloc'd JSON array of decl-node records; caller frees with
//       smn_free. Two-pass semantics identical to scan_snapshot():
//       pass 1 collects declared type names across ALL files, pass 2
//       scans each file against that set.
//   void smn_free(char*)
//   int  smn_abi_version()
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <functional>
#include <thread>
#include <cstdlib>
#include <cstdio>
#include <string>
#include <string_view>
#include <vector>
#include <unordered_set>

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4), enough for symbolId = first 16 hex chars.

namespace sha256 {

static const uint32_t K[64] = {
    0x428a2f98,0x71374491,0xb5c0fbcf,0xe9b5dba5,0x3956c25b,0x59f111f1,
    0x923f82a4,0xab1c5ed5,0xd807aa98,0x12835b01,0x243185be,0x550c7dc3,
    0x72be5d74,0x80deb1fe,0x9bdc06a7,0xc19bf174,0xe49b69c1,0xefbe4786,
    0x0fc19dc6,0x240ca1cc,0x2de92c6f,0x4a7484aa,0x5cb0a9dc,0x76f988da,
    0x983e5152,0xa831c66d,0xb00327c8,0xbf597fc7,0xc6e00bf3,0xd5a79147,
    0x06ca6351,0x14292967,0x27b70a85,0x2e1b2138,0x4d2c6dfc,0x53380d13,
    0x650a7354,0x766a0abb,0x81c2c92e,0x92722c85,0xa2bfe8a1,0xa81a664b,
    0xc24b8b70,0xc76c51a3,0xd192e819,0xd6990624,0xf40e3585,0x106aa070,
    0x19a4c116,0x1e376c08,0x2748774c,0x34b0bcb5,0x391c0cb3,0x4ed8aa4a,
    0x5b9cca4f,0x682e6ff3,0x748f82ee,0x78a5636f,0x84c87814,0x8cc70208,
    0x90befffa,0xa4506ceb,0xbef9a3f7,0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

struct Ctx {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buflen = 0;
  Ctx() {
    h[0]=0x6a09e667; h[1]=0xbb67ae85; h[2]=0x3c6ef372; h[3]=0xa54ff53a;
    h[4]=0x510e527f; h[5]=0x9b05688c; h[6]=0x1f83d9ab; h[7]=0x5be0cd19;
  }
  void block(const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[i*4]) << 24) | (uint32_t(p[i*4+1]) << 16) |
             (uint32_t(p[i*4+2]) << 8) | uint32_t(p[i*4+3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i-15],7) ^ rotr(w[i-15],18) ^ (w[i-15] >> 3);
      uint32_t s1 = rotr(w[i-2],17) ^ rotr(w[i-2],19) ^ (w[i-2] >> 10);
      w[i] = w[i-16] + s0 + w[i-7] + s1;
    }
    uint32_t a=h[0],b=h[1],c=h[2],d=h[3],e=h[4],f=h[5],g=h[6],hh=h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e,6) ^ rotr(e,11) ^ rotr(e,25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a,2) ^ rotr(a,13) ^ rotr(a,22);
      uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + mj;
      hh=g; g=f; f=e; e=d+t1; d=c; c=b; b=a; a=t1+t2;
    }
    h[0]+=a; h[1]+=b; h[2]+=c; h[3]+=d; h[4]+=e; h[5]+=f; h[6]+=g; h[7]+=hh;
  }
  void update(const uint8_t* p, size_t n) {
    len += n;
    while (n) {
      size_t take = 64 - buflen; if (take > n) take = n;
      memcpy(buf + buflen, p, take);
      buflen += take; p += take; n -= take;
      if (buflen == 64) { block(buf); buflen = 0; }
    }
  }
  void final(uint8_t out[32]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (buflen != 56) update(&z, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - 8*i));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[i*4]   = uint8_t(h[i] >> 24);
      out[i*4+1] = uint8_t(h[i] >> 16);
      out[i*4+2] = uint8_t(h[i] >> 8);
      out[i*4+3] = uint8_t(h[i]);
    }
  }
};

// First n_hex hex chars of sha256(data).
static std::string hex16(std::string_view data) {
  Ctx c;
  c.update(reinterpret_cast<const uint8_t*>(data.data()), data.size());
  uint8_t out[32];
  c.final(out);
  static const char* digits = "0123456789abcdef";
  std::string s;
  s.reserve(16);
  for (int i = 0; i < 8; i++) {  // 8 bytes → 16 hex chars
    s.push_back(digits[out[i] >> 4]);
    s.push_back(digits[out[i] & 0xf]);
  }
  return s;
}

}  // namespace sha256

// ---------------------------------------------------------------------------
// Tokenizer — port of semantic_merge_tpu_torch/frontend/tokenizer.py.

enum TokType : uint8_t { T_IDENT, T_NUMBER, T_STRING, T_TEMPLATE, T_REGEX, T_PUNCT };

struct Token {
  TokType type;
  std::string_view text;
  int start;
  int end;
  int prev_end;
  bool nl_before;
};

// Longest-match-first operator table — EXACT order of tokenizer.py.
static const char* OPERATORS[] = {
    ">>>=", "...", "===", "!==", "**=", "<<=", ">>=", ">>>", "&&=", "||=", "?\?=",
    "=>", "==", "!=", "<=", ">=", "&&", "||", "??", "?.", "++", "--", "+=", "-=",
    "*=", "/=", "%=", "&=", "|=", "^=", "<<", ">>", "**",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/", "%",
    "&", "|", "^", "!", "~", "?", ":", "=", ".", "@", "#",
};
static const int N_OPERATORS = sizeof(OPERATORS) / sizeof(OPERATORS[0]);

static inline bool is_ident_start(char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || c == '_' || c == '$';
}
static inline bool is_digit(char c) { return c >= '0' && c <= '9'; }
static inline bool is_ident_part(char c) { return is_ident_start(c) || is_digit(c); }
static inline bool is_alnum(char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || is_digit(c);
}

static const std::unordered_set<std::string_view> REGEX_ALLOWED_KEYWORDS = {
    "return", "typeof", "instanceof", "in", "of", "new", "delete", "void",
    "throw", "case", "do", "else", "yield", "await",
};

static bool regex_allowed(const std::vector<Token>& toks) {
  if (toks.empty()) return true;
  const Token& prev = toks.back();
  if (prev.type == T_NUMBER || prev.type == T_STRING || prev.type == T_TEMPLATE ||
      prev.type == T_REGEX)
    return false;
  if (prev.type == T_IDENT) return REGEX_ALLOWED_KEYWORDS.count(prev.text) != 0;
  return !(prev.text == ")" || prev.text == "]" || prev.text == "}" ||
           prev.text == "++" || prev.text == "--");
}

static int scan_string(std::string_view t, int i, char quote) {
  int n = int(t.size());
  i += 1;
  while (i < n) {
    char c = t[i];
    if (c == '\\') { i += 2; continue; }
    if (c == quote || c == '\n') return i + 1;
    i += 1;
  }
  return n;
}

static int scan_regex(std::string_view t, int i) {
  int n = int(t.size());
  i += 1;
  bool in_class = false;
  while (i < n) {
    char c = t[i];
    if (c == '\\') { i += 2; continue; }
    if (c == '[') in_class = true;
    else if (c == ']') in_class = false;
    else if (c == '/' && !in_class) {
      i += 1;
      while (i < n && is_ident_part(t[i])) i += 1;
      return i;
    } else if (c == '\n') return i;
    i += 1;
  }
  return n;
}

static int scan_template(std::string_view t, int i);

static int scan_substitution(std::string_view t, int i) {
  int n = int(t.size());
  int depth = 1;
  while (i < n) {
    char c = t[i];
    if (c == '\\') { i += 2; continue; }
    if (c == '\'' || c == '"') { i = scan_string(t, i, c); continue; }
    if (c == '`') { i = scan_template(t, i); continue; }
    if (c == '{') depth += 1;
    else if (c == '}') {
      depth -= 1;
      if (depth == 0) return i + 1;
    }
    i += 1;
  }
  return n;
}

static int scan_template(std::string_view t, int i) {
  int n = int(t.size());
  i += 1;
  while (i < n) {
    char c = t[i];
    if (c == '\\') { i += 2; continue; }
    if (c == '`') return i + 1;
    if (c == '$' && i + 1 < n && t[i + 1] == '{') {
      i = scan_substitution(t, i + 2);
      continue;
    }
    i += 1;
  }
  return n;
}

static const char* match_operator(std::string_view t, int i) {
  for (int k = 0; k < N_OPERATORS; k++) {
    const char* op = OPERATORS[k];
    size_t len = strlen(op);
    if (t.size() - size_t(i) >= len && memcmp(t.data() + i, op, len) == 0) return op;
  }
  return nullptr;
}

static std::vector<Token> tokenize(std::string_view text) {
  std::vector<Token> toks;
  toks.reserve(text.size() / 6 + 8);
  int i = 0;
  int n = int(text.size());
  int prev_end = 0;
  bool nl_before = false;
  while (i < n) {
    char c = text[i];
    if (c == ' ' || c == '\t' || c == '\r' || c == '\f' || c == '\v') { i += 1; continue; }
    if (c == '\n') { nl_before = true; i += 1; continue; }
    if (c == '/' && i + 1 < n) {
      if (text[i + 1] == '/') {
        size_t j = text.find('\n', i);
        i = (j == std::string_view::npos) ? n : int(j);
        continue;
      }
      if (text[i + 1] == '*') {
        size_t j = text.find("*/", i + 2);
        if (j == std::string_view::npos) { i = n; continue; }
        if (text.substr(i, j - i).find('\n') != std::string_view::npos) nl_before = true;
        i = int(j) + 2;
        continue;
      }
    }
    int start = i;
    Token tok;
    if (is_ident_start(c)) {
      while (i < n && is_ident_part(text[i])) i += 1;
      tok = {T_IDENT, text.substr(start, i - start), start, i, prev_end, nl_before};
    } else if (is_digit(c) || (c == '.' && i + 1 < n && is_digit(text[i + 1]))) {
      while (i < n && (is_alnum(text[i]) || text[i] == '.' || text[i] == '_')) i += 1;
      tok = {T_NUMBER, text.substr(start, i - start), start, i, prev_end, nl_before};
    } else if (c == '\'' || c == '"') {
      i = scan_string(text, i, c);
      tok = {T_STRING, text.substr(start, i - start), start, i, prev_end, nl_before};
    } else if (c == '`') {
      i = scan_template(text, i);
      tok = {T_TEMPLATE, text.substr(start, i - start), start, i, prev_end, nl_before};
    } else if (c == '/' && regex_allowed(toks)) {
      i = scan_regex(text, i);
      tok = {T_REGEX, text.substr(start, i - start), start, i, prev_end, nl_before};
    } else {
      const char* op = match_operator(text, i);
      if (op == nullptr) { i += 1; continue; }  // stray byte: skip
      i += int(strlen(op));
      tok = {T_PUNCT, text.substr(start, i - start), start, i, prev_end, nl_before};
    }
    toks.push_back(tok);
    prev_end = tok.end;
    nl_before = false;
  }
  return toks;
}

// ---------------------------------------------------------------------------
// Scanner — port of semantic_merge_tpu_torch/frontend/scanner.py.

static const char* KIND_FUNCTION = "FunctionDeclaration";
static const char* KIND_CLASS = "ClassDeclaration";
static const char* KIND_INTERFACE = "InterfaceDeclaration";
static const char* KIND_ENUM = "EnumDeclaration";
static const char* KIND_VARS = "VariableStatement";

static const std::unordered_set<std::string_view> EXPRESSION_PREV = {
    "=", "(", "[", ",", ":", "?", "!", "&", "|", "+", "-", "*", "/", "%",
    "<", ">", "=>", "==", "===", "!=", "!==", "&&", "||", "??", "...",
    "+=", "-=", "*=", "/=", "?\?=", "&&=", "||=", ".", "?.",
};
static const std::unordered_set<std::string_view> EXPRESSION_PREV_IDENTS = {
    "return", "typeof", "new", "delete", "void", "in", "of", "instanceof",
    "yield", "await", "case", "do", "throw", "extends", "default",
};
static const std::unordered_set<std::string_view> DECL_MODIFIERS = {
    "export", "default", "declare", "async", "abstract", "public", "private",
    "protected",
};
static const std::unordered_set<std::string_view> PRIMITIVE_TYPES = {
    "string", "number", "boolean", "any", "unknown", "never", "void", "object",
    "undefined", "null", "bigint", "symbol", "this", "true", "false",
};

struct DeclNode {
  std::string symbolId;
  std::string addressId;
  const char* kind;
  std::string name;   // empty + has_name=false → null
  bool has_name;
  std::string file;
  int pos;
  int end;
  std::string signature;
};

using TokVec = std::vector<Token>;
using StrSet = std::unordered_set<std::string>;

static std::string normalize_path(std::string p) {
  for (auto& ch : p)
    if (ch == '\\') ch = '/';
  if (p.rfind("./", 0) == 0) p = p.substr(2);
  if (!p.empty() && p[0] == '/') p = p.substr(1);
  return p;
}

static bool is_expression_position(const TokVec& toks, int i) {
  int j = i - 1;
  while (j >= 0 && toks[j].type == T_IDENT && DECL_MODIFIERS.count(toks[j].text)) j -= 1;
  if (j < 0) return false;
  const Token& prev = toks[j];
  if (prev.type == T_PUNCT) return EXPRESSION_PREV.count(prev.text) != 0;
  if (prev.type == T_IDENT) return EXPRESSION_PREV_IDENTS.count(prev.text) != 0;
  return true;
}

static StrSet collect_type_names(const TokVec& toks) {
  StrSet names;
  int n = int(toks.size());
  for (int i = 0; i < n; i++) {
    const Token& t = toks[i];
    if (t.type != T_IDENT || i + 1 >= n) continue;
    const Token& nxt = toks[i + 1];
    bool head = (t.text == "class" || t.text == "interface" || t.text == "enum" ||
                 t.text == "type");
    if (head && nxt.type == T_IDENT) {
      if (t.text == "type" &&
          (i + 2 >= n || !(toks[i + 2].text == "=" || toks[i + 2].text == "<")))
        continue;
      if (t.text == "class" && is_expression_position(toks, i)) continue;
      names.insert(std::string(nxt.text));
    }
  }
  return names;
}

// Index of the `@` starting a (possibly dotted) decorator name ending
// just before j — `@Name` / `@ns.sub.Name` — or -1 (twin of
// scanner._decorator_start).
static int decorator_start(const TokVec& toks, int j) {
  int t = j - 1;
  if (t < 0 || toks[t].type != T_IDENT) return -1;
  while (t - 2 >= 0 && toks[t - 1].text == "." && toks[t - 2].type == T_IDENT)
    t -= 2;
  if (t - 1 >= 0 && toks[t - 1].text == "@") return t - 1;
  return -1;
}

static int full_start(const TokVec& toks, int i) {
  // Walk back over modifiers AND decorators: TS parses `@dec` as part
  // of the declaration node, so the node's pos starts before it
  // (twin of scanner._full_start).
  int j = i;
  while (j - 1 >= 0) {
    const Token& prev = toks[j - 1];
    if (prev.type == T_IDENT && DECL_MODIFIERS.count(std::string(prev.text))) {
      j -= 1;
      continue;
    }
    if (prev.text == ")") {  // @ Name( ... ) / @ ns.Name( ... )
      int k = j - 1, depth = 0;
      while (k >= 0) {
        if (toks[k].text == ")") depth += 1;
        else if (toks[k].text == "(") {
          depth -= 1;
          if (depth == 0) break;
        }
        k -= 1;
      }
      int start = decorator_start(toks, k);
      if (start >= 0) {
        j = start;
        continue;
      }
    }
    if (prev.type == T_IDENT) {
      int start = decorator_start(toks, j);
      if (start >= 0) {
        j = start;
        continue;
      }
    }
    break;
  }
  return toks[j].prev_end;
}

// (names, index_after) for a `<T, U extends X = Y>` list at i. Type
// parameters resolve lexically: the checker renders a type-parameter
// reference by its name even with no default lib, so the signature
// renderers treat these names as in-scope types (twin of
// scanner._type_param_names).
static int type_param_names(const TokVec& toks, int i,
                            std::vector<std::string>* names) {
  int n = int(toks.size());
  if (i < n && toks[i].text == "<") {
    int depth = 0;
    bool expecting = false;
    while (i < n) {
      const auto& t = toks[i].text;
      if (t == "<") {
        depth += 1;
        if (depth == 1) expecting = true;
      } else if (t == ">" || t == ">>" || t == ">>>") {
        depth -= int(t.size());  // count of '>' chars
        if (depth <= 0) return i + 1;
      } else if (depth == 1 && t == ",") {
        expecting = true;
      } else if (expecting && depth == 1 && toks[i].type == T_IDENT &&
                 t != "const" && t != "in" && t != "out") {
        if (names) names->push_back(std::string(t));
        expecting = false;
      }
      i += 1;
    }
  }
  return i;
}

static int skip_type_params(const TokVec& toks, int i) {
  return type_param_names(toks, i, nullptr);
}

static int matching_brace(const TokVec& toks, int i) {
  int depth = 0;
  int n = int(toks.size());
  while (i < n) {
    if (toks[i].text == "{") depth += 1;
    else if (toks[i].text == "}") {
      depth -= 1;
      if (depth == 0) return i;
    }
    i += 1;
  }
  return n - 1;
}

static int matching_paren(const TokVec& toks, int i) {
  int depth = 0;
  int n = int(toks.size());
  while (i < n) {
    if (toks[i].text == "(") depth += 1;
    else if (toks[i].text == ")") {
      depth -= 1;
      if (depth == 0) return i;
    }
    i += 1;
  }
  return n - 1;
}

static bool has_default_modifier(const TokVec& toks, int i) {
  int j = i - 1;
  while (j >= 0 && toks[j].type == T_IDENT && DECL_MODIFIERS.count(toks[j].text)) {
    if (toks[j].text == "default") return true;
    j -= 1;
  }
  return false;
}

// --- type display (typeToString emulation) ---------------------------------

static std::string render_type_text(const std::vector<std::string_view>& parts,
                                    const StrSet& declared);

static std::vector<std::vector<std::string_view>> split_top(
    const std::vector<std::string_view>& parts, std::string_view sep) {
  std::vector<std::vector<std::string_view>> out;
  out.emplace_back();
  int depth = 0;
  for (const auto& p : parts) {
    if (p == "(" || p == "[" || p == "{" || p == "<") depth += 1;
    else if (p == ")" || p == "]" || p == "}" || p == ">") depth -= 1;
    if (p == sep && depth == 0) out.emplace_back();
    else out.back().push_back(p);
  }
  return out;
}

static bool is_numeric_literal(std::string_view name) {
  size_t k = 0;
  while (k < name.size() && name[k] == '-') k += 1;  // lstrip("-")
  if (k == name.size()) return false;
  for (; k < name.size(); k++)
    if (!is_digit(name[k])) return false;
  return true;
}

// Python str.isidentifier() for the ASCII subset the tokenizer emits:
// letters/underscore start, letters/digits/underscore continue ('$' is
// an identifier char in JS but NOT in Python — parity with the oracle).
static bool is_identifier_text(std::string_view s) {
  if (s.empty()) return false;
  char c0 = s[0];
  if (!((c0 >= 'a' && c0 <= 'z') || (c0 >= 'A' && c0 <= 'Z') || c0 == '_'))
    return false;
  for (size_t k = 1; k < s.size(); k++) {
    char c = s[k];
    if (!((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || is_digit(c) ||
          c == '_'))
      return false;
  }
  return true;
}

static std::string join(const std::vector<std::string_view>& parts,
                        const char* sep) {
  std::string out;
  for (size_t k = 0; k < parts.size(); k++) {
    if (k) out += sep;
    out.append(parts[k].data(), parts[k].size());
  }
  return out;
}

static std::string render_type_text(const std::vector<std::string_view>& parts,
                                    const StrSet& declared) {
  if (parts.empty()) return "any";  // e.g. trailing comma's empty element
  // Union / intersection at top level.
  for (const char* op : {"|", "&"}) {
    auto pieces = split_top(parts, op);
    if (pieces.size() > 1) {
      std::string out;
      for (size_t k = 0; k < pieces.size(); k++) {
        if (k) { out += " "; out += op; out += " "; }
        out += render_type_text(pieces[k], declared);
      }
      return out;
    }
  }
  // Trailing [] — array type.
  if (parts.size() >= 2 && parts[parts.size() - 1] == "]" &&
      parts[parts.size() - 2] == "[") {
    std::vector<std::string_view> inner(parts.begin(), parts.end() - 2);
    std::string elem = render_type_text(inner, declared);
    if (elem.find(" | ") != std::string::npos || elem.find(" & ") != std::string::npos)
      return "(" + elem + ")[]";
    return elem + "[]";
  }
  // Parenthesized. (After the union check, no depth-0 "|" remains, so the
  // Python `_split_top(parts, "|") == [parts]` guard is always true here.)
  if (!parts.empty() && parts[0] == "(") {
    if (parts.back() == ")") {
      std::vector<std::string_view> inner(parts.begin() + 1, parts.end() - 1);
      return render_type_text(inner, declared);
    }
  }
  if (parts.size() == 1) {
    std::string_view name = parts[0];
    if (PRIMITIVE_TYPES.count(name) || is_numeric_literal(name) ||
        (!name.empty() && (name[0] == '\'' || name[0] == '"' || name[0] == '`')))
      return std::string(name);
    return declared.count(std::string(name)) ? std::string(name) : "any";
  }
  // Generic reference ``Name<...>`` — unresolved without a default lib.
  if (!parts.empty() && !PRIMITIVE_TYPES.count(parts[0]) && parts.size() >= 2 &&
      parts[1] == "<")
    return declared.count(std::string(parts[0])) ? std::string(parts[0]) : "any";
  // Qualified name ``Ns.Thing`` — namespaces are not indexed decl kinds,
  // so the no-default-lib checker cannot resolve the root: "any".
  if (parts.size() >= 3 && parts.size() % 2 == 1) {
    bool qualified = true;
    for (size_t k = 1; k < parts.size(); k += 2)
      if (parts[k] != ".") { qualified = false; break; }
    if (qualified)
      for (size_t k = 0; k < parts.size(); k += 2)
        if (!is_identifier_text(parts[k])) { qualified = false; break; }
    if (qualified) return "any";
  }
  // Tuple type ``[A, B]`` — render element-wise like the checker.
  if (!parts.empty() && parts[0] == "[" && parts.back() == "]" &&
      parts.size() > 2) {
    std::vector<std::string_view> inner(parts.begin() + 1, parts.end() - 1);
    auto elems = split_top(inner, ",");
    std::string out = "[";
    bool first = true;
    for (auto& elem : elems) {
      if (elem.empty()) continue;  // trailing comma's empty element drops
      if (!first) out += ", ";
      first = false;
      out += render_type_text(elem, declared);
    }
    return out + "]";
  }
  // Fallback display with checker-style punctuation spacing: no space
  // before ":,;.)]>", none after "([<.".
  std::vector<std::string> grouped;
  for (const auto& p : parts) {
    bool attach = false;
    if (!grouped.empty()) {
      char last = grouped.back().back();
      if (p == "," || p == ";" || p == ":" || p == ")" || p == "]" ||
          p == ">" || p == ".")
        attach = true;
      else if (last == '(' || last == '[' || last == '<' || last == '.')
        attach = true;
    }
    if (attach) grouped.back().append(p.data(), p.size());
    else grouped.emplace_back(p);
  }
  std::string out;
  for (size_t k = 0; k < grouped.size(); k++) {
    if (k) out += " ";
    out += grouped[k];
  }
  return out;
}

static std::string render_type(const std::vector<const Token*>& type_toks,
                               const StrSet& declared) {
  if (type_toks.empty()) return "any";
  std::vector<std::string_view> parts;
  parts.reserve(type_toks.size());
  for (const Token* t : type_toks) parts.push_back(t->text);
  return render_type_text(parts, declared);
}

// --- parameter / annotation parsing ----------------------------------------

static std::vector<const Token*> annotation_of(const std::vector<const Token*>& ptoks) {
  int depth = 0;
  int start = -1;
  for (size_t idx = 0; idx < ptoks.size(); idx++) {
    std::string_view t = ptoks[idx]->text;
    if (t == "(" || t == "[" || t == "{" || t == "<") depth += 1;
    else if (t == ")" || t == "]" || t == "}" || t == ">") depth -= 1;
    else if (depth == 0 && t == ":" && start < 0) start = int(idx) + 1;
    else if (depth == 0 && t == "=" && start >= 0)
      return {ptoks.begin() + start, ptoks.begin() + idx};
    else if (depth == 0 && t == "=" && start < 0)
      return {};
  }
  if (start >= 0) return {ptoks.begin() + start, ptoks.end()};
  return {};
}

static std::vector<std::string> parse_param_types(
    const std::vector<const Token*>& param_toks, const StrSet& declared) {
  std::vector<std::string> types;
  if (param_toks.empty()) return types;
  std::vector<std::vector<const Token*>> params;
  params.emplace_back();
  int depth = 0;
  for (const Token* t : param_toks) {
    std::string_view x = t->text;
    if (x == "(" || x == "[" || x == "{" || x == "<") depth += 1;
    else if (x == ")" || x == "]" || x == "}" || x == ">") depth -= 1;
    if (x == "," && depth == 0) params.emplace_back();
    else params.back().push_back(t);
  }
  for (const auto& ptoks : params) {
    if (ptoks.empty()) continue;
    auto ann = annotation_of(ptoks);
    types.push_back(ann.empty() ? "any" : render_type(ann, declared));
  }
  return types;
}

// A depth-0 "{" after one of these continues the type (object-literal
// type position); after a completed type atom it opens the body.
static const StrSet TYPE_EXPECTED_AFTER = {":", "|", "&", "(", ",", "<", "=>",
                                           "extends", "keyof", "readonly", "?"};

static std::pair<std::vector<const Token*>, int> collect_type_tokens(
    const TokVec& toks, int i, const StrSet& stop) {
  std::vector<const Token*> out;
  int depth = 0;
  int n = int(toks.size());
  bool expecting = true;  // start of annotation: a type is expected
  while (i < n) {
    const Token& t = toks[i];
    std::string txt(t.text);
    if (depth == 0 && stop.count(txt) && !(txt == "{" && expecting)) break;
    if (t.text == "(" || t.text == "[" || t.text == "<" || t.text == "{") depth += 1;
    else if (t.text == ")" || t.text == "]" || t.text == ">" || t.text == "}") {
      if (depth == 0) break;
      depth -= 1;
    }
    expecting = TYPE_EXPECTED_AFTER.count(txt) != 0;
    out.push_back(&t);
    i += 1;
  }
  return {out, i};
}

// --- node construction ------------------------------------------------------

static DeclNode mk_node(const std::string& path, const TokVec& toks, int start_i,
                        int end_i, const char* kind, const std::string& name,
                        bool has_name, const std::string& sig) {
  int pos = full_start(toks, start_i);
  int end = toks[std::min(end_i, int(toks.size()) - 1)].end;
  std::string address = path + "::" + (has_name ? name : std::string("anon")) +
                        "::" + std::to_string(pos);
  DeclNode node;
  node.symbolId = sha256::hex16(sig);
  node.addressId = address;
  node.kind = kind;
  node.name = name;
  node.has_name = has_name;
  node.file = path;
  node.pos = pos;
  node.end = end;
  node.signature = sig;
  return node;
}

// --- function declarations --------------------------------------------------

static bool scan_function(const std::string& path, const TokVec& toks, int i,
                          const StrSet& declared, DeclNode* out) {
  if (is_expression_position(toks, i)) return false;
  int n = int(toks.size());
  int j = i + 1;
  if (j < n && toks[j].text == "*") j += 1;  // generator
  std::string name;
  bool has_name = false;
  if (j < n && toks[j].type == T_IDENT) {
    name = std::string(toks[j].text);
    has_name = true;
    j += 1;
  }
  std::vector<std::string> tp_names;
  j = type_param_names(toks, j, &tp_names);
  if (j >= n || toks[j].text != "(") return false;
  if (!has_name && !has_default_modifier(toks, i)) return false;
  // The decl's own type parameters are lexically in scope for its
  // param/return annotations and render by name (checker semantics).
  StrSet local_owned;
  const StrSet* scope = &declared;
  if (!tp_names.empty()) {
    local_owned = declared;
    for (auto& nm : tp_names) local_owned.insert(nm);
    scope = &local_owned;
  }
  int params_start = j;
  int params_end = matching_paren(toks, params_start);
  std::vector<const Token*> ptoks;
  for (int k = params_start + 1; k < params_end; k++) ptoks.push_back(&toks[k]);
  auto param_types = parse_param_types(ptoks, *scope);
  int k = params_end + 1;
  std::string ret_type = "any";
  if (k < n && toks[k].text == ":") {
    static const StrSet stop = {"{", ";"};
    auto [type_toks, k2] = collect_type_tokens(toks, k + 1, stop);
    ret_type = render_type(type_toks, *scope);
    k = k2;
  }
  int end_idx;
  if (k < n && toks[k].text == "{") end_idx = matching_brace(toks, k);
  else if (k < n && toks[k].text == ";") end_idx = k;
  else end_idx = params_end;
  std::string sig = "fn(";
  for (size_t q = 0; q < param_types.size(); q++) {
    if (q) sig += ",";
    sig += param_types[q];
  }
  sig += ")->" + ret_type;
  *out = mk_node(path, toks, i, end_idx, KIND_FUNCTION, name, has_name, sig);
  return true;
}

// --- class / interface / enum -----------------------------------------------

static bool asi_break(const Token& prev, const Token& cur) {
  if (prev.type == T_PUNCT &&
      !(prev.text == ")" || prev.text == "]" || prev.text == "}"))
    return false;
  if (cur.type == T_PUNCT && !(cur.text == "[" || cur.text == "@" || cur.text == "#"))
    return false;
  static const std::unordered_set<std::string_view> member_heads = {
      "get", "set", "static", "readonly", "public", "private", "protected",
      "abstract", "async", "new"};
  if (prev.type == T_IDENT && member_heads.count(prev.text)) return false;
  return true;
}

static int member_end(const TokVec& toks, int i, int body_end, bool allow_method_body) {
  int depth = 0;
  bool seen_eq = false;
  int n = body_end;
  int start = i;  // the ASI check must not fire on the member's own first token
  while (i < n) {
    const Token& t = toks[i];
    if (t.text == "(" || t.text == "[") depth += 1;
    else if (t.text == ")" || t.text == "]") depth -= 1;
    else if (t.text == "{") {
      if (depth == 0 && !seen_eq && allow_method_body)
        return matching_brace(toks, i) + 1;
      depth += 1;
    } else if (t.text == "}") depth -= 1;
    else if (depth == 0) {
      if (t.text == "=") seen_eq = true;
      else if (t.text == ";" || t.text == ",") return i + 1;
      else if (t.nl_before && i > start && asi_break(toks[i - 1], t)) return i;
    }
    i += 1;
  }
  return n;
}

static int count_class_members(const TokVec& toks, int body_start, int body_end) {
  int count = 0;
  int i = body_start + 1;
  while (i < body_end) {
    if (toks[i].text == ";") { count += 1; i += 1; continue; }
    count += 1;
    i = member_end(toks, i, body_end, /*allow_method_body=*/true);
  }
  return count;
}

static int count_interface_members(const TokVec& toks, int body_start, int body_end) {
  int count = 0;
  int i = body_start + 1;
  while (i < body_end) {
    if (toks[i].text == ";" || toks[i].text == ",") { i += 1; continue; }
    count += 1;
    i = member_end(toks, i, body_end, /*allow_method_body=*/false);
  }
  return count;
}

static int count_enum_members(const TokVec& toks, int body_start, int body_end) {
  int count = 0;
  int depth = 0;
  bool has_content = false;
  for (int i = body_start + 1; i < body_end; i++) {
    const Token& t = toks[i];
    if (t.text == "(" || t.text == "[" || t.text == "{") depth += 1;
    else if (t.text == ")" || t.text == "]" || t.text == "}") depth -= 1;
    else if (t.text == "," && depth == 0) {
      if (has_content) count += 1;
      has_content = false;
      continue;
    }
    if (depth == 0 && t.text != ",") has_content = true;
  }
  if (has_content) count += 1;
  return count;
}

static bool scan_braced_decl(const std::string& path, const TokVec& toks, int i,
                             const char* kind, DeclNode* out) {
  if (is_expression_position(toks, i)) return false;
  int n = int(toks.size());
  int j = i + 1;
  std::string name;
  bool has_name = false;
  if (j < n && toks[j].type == T_IDENT && toks[j].text != "extends" &&
      toks[j].text != "implements") {
    name = std::string(toks[j].text);
    has_name = true;
    j += 1;
  }
  if (!has_name && (kind == KIND_INTERFACE || kind == KIND_ENUM)) return false;
  j = skip_type_params(toks, j);
  while (j < n && toks[j].text != "{") {
    if (toks[j].text == ";" || toks[j].text == ")") return false;
    j += 1;
  }
  if (j >= n) return false;
  int body_start = j;
  int body_end = matching_brace(toks, body_start);
  std::string sig;
  if (kind == KIND_CLASS)
    sig = "class{" + std::to_string(count_class_members(toks, body_start, body_end)) + "}";
  else if (kind == KIND_INTERFACE)
    sig = "iface{" + std::to_string(count_interface_members(toks, body_start, body_end)) + "}";
  else
    sig = "enum{" + std::to_string(count_enum_members(toks, body_start, body_end)) + "}";
  int start_i = i;
  if (kind == KIND_ENUM && i - 1 >= 0 && toks[i - 1].text == "const") start_i = i - 1;
  *out = mk_node(path, toks, start_i, body_end, kind, name, has_name, sig);
  return true;
}

// --- variable statements -----------------------------------------------------

static bool var_asi_break(const Token& prev, const Token& cur) {
  if (prev.type == T_PUNCT &&
      !(prev.text == ")" || prev.text == "]" || prev.text == "}"))
    return false;
  if (cur.type == T_PUNCT &&
      (cur.text == "+" || cur.text == "-" || cur.text == "*" || cur.text == "/" ||
       cur.text == "." || cur.text == "?." || cur.text == "=" || cur.text == "(" ||
       cur.text == "[" || cur.text == "`"))
    return false;
  if (cur.type == T_IDENT &&
      (cur.text == "instanceof" || cur.text == "in" || cur.text == "of" ||
       cur.text == "as"))
    return false;
  return true;
}

static bool scan_var_statement(const std::string& path, const TokVec& toks, int i,
                               DeclNode* out) {
  int n = int(toks.size());
  if (i + 1 < n && toks[i + 1].text == "enum") return false;  // const enum
  if (i + 1 >= n ||
      !(toks[i + 1].type == T_IDENT || toks[i + 1].text == "[" || toks[i + 1].text == "{"))
    return false;
  if (toks[i + 1].type == T_IDENT &&
      (toks[i + 1].text == "in" || toks[i + 1].text == "of" ||
       toks[i + 1].text == "instanceof"))
    return false;
  int j = i - 1;
  if (j >= 0 && toks[j].text == "(" && j - 1 >= 0 && toks[j - 1].type == T_IDENT &&
      (toks[j - 1].text == "for" || toks[j - 1].text == "await"))
    return false;
  if (is_expression_position(toks, i)) return false;
  int depth = 0;
  int declarators = 1;
  int k = i + 1;
  int end_idx = i;
  while (k < n) {
    const Token& t2 = toks[k];
    if (t2.text == "(" || t2.text == "[" || t2.text == "{") depth += 1;
    else if (t2.text == ")" || t2.text == "]") {
      depth -= 1;
      if (depth < 0) break;
    } else if (t2.text == "}") {
      depth -= 1;
      if (depth < 0) break;
    } else if (depth == 0) {
      if (t2.text == ";") { end_idx = k; break; }
      if (t2.text == ",") declarators += 1;
      else if (t2.nl_before && var_asi_break(toks[k - 1], t2)) break;
      else if (t2.type == T_IDENT && (t2.text == "of" || t2.text == "in") &&
               toks[k - 1].type == T_IDENT)
        return false;
    }
    end_idx = k;
    k += 1;
  }
  std::string sig = "vars{" + std::to_string(declarators) + "}";
  *out = mk_node(path, toks, i, end_idx, KIND_VARS, "", /*has_name=*/false, sig);
  return true;
}

// --- file scan ---------------------------------------------------------------

static void scan_tokens(const std::string& path, const TokVec& toks,
                        const StrSet& declared, std::vector<DeclNode>* nodes) {
  int n = int(toks.size());
  for (int i = 0; i < n; i++) {
    const Token& t = toks[i];
    if (t.type != T_IDENT) continue;
    std::string_view word = t.text;
    DeclNode node;
    bool ok = false;
    if (word == "function") ok = scan_function(path, toks, i, declared, &node);
    else if (word == "class") ok = scan_braced_decl(path, toks, i, KIND_CLASS, &node);
    else if (word == "interface") ok = scan_braced_decl(path, toks, i, KIND_INTERFACE, &node);
    else if (word == "enum") ok = scan_braced_decl(path, toks, i, KIND_ENUM, &node);
    else if (word == "var" || word == "let" || word == "const")
      ok = scan_var_statement(path, toks, i, &node);
    if (ok) nodes->push_back(std::move(node));
  }
}

// ---------------------------------------------------------------------------
// JSON output.

static void json_escape(const std::string& s, std::string* out) {
  for (unsigned char c : s) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\n': *out += "\\n"; break;
      case '\t': *out += "\\t"; break;
      case '\r': *out += "\\r"; break;
      case '\b': *out += "\\b"; break;
      case '\f': *out += "\\f"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          *out += buf;
        } else {
          out->push_back(char(c));
        }
    }
  }
}

static void append_node_json(const DeclNode& n, std::string* out) {
  *out += "{\"symbolId\":\"";
  json_escape(n.symbolId, out);
  *out += "\",\"addressId\":\"";
  json_escape(n.addressId, out);
  *out += "\",\"kind\":\"";
  *out += n.kind;
  *out += "\",\"name\":";
  if (n.has_name) {
    *out += "\"";
    json_escape(n.name, out);
    *out += "\"";
  } else {
    *out += "null";
  }
  *out += ",\"file\":\"";
  json_escape(n.file, out);
  *out += "\",\"pos\":" + std::to_string(n.pos);
  *out += ",\"end\":" + std::to_string(n.end);
  *out += ",\"signature\":\"";
  json_escape(n.signature, out);
  *out += "\"}";
}

// ---------------------------------------------------------------------------
// C ABI.

// ---------------------------------------------------------------------------
// Parallel helper: run fn(i) for i in [0, n) across a small thread pool.
// Per-file work (tokenize / scan) is independent; only the declared-set
// merge and output concatenation are sequential — the work-stealing
// parse/bind pool the reference designs but never builds (reference
// architecture.md "parallelism model": parallel per file/package).

static void parallel_for(int n, const std::function<void(int)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = int(hw ? hw : 4);
  if (n_threads > n) n_threads = n;
  if (n_threads <= 1 || n < 32) {  // small snapshots: threads cost more
    for (int i = 0; i < n; i++) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) {
    pool.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

extern "C" {

int smn_abi_version() { return 4; }

// Scan a snapshot: two passes exactly like scan_snapshot() — collect
// declared type names across all files, then scan each file in snapshot
// order. Per-file tokenize and scan run thread-parallel; node order
// stays deterministic (concatenation in snapshot order). Returns a
// malloc'd JSON array; free with smn_free.
char* smn_scan_snapshot(const char** paths, const char** contents, int n_files) {
  std::vector<std::string> sources(n_files);
  std::vector<std::string> norm_paths(n_files);
  std::vector<TokVec> toks(n_files);
  std::vector<StrSet> names(n_files);
  parallel_for(n_files, [&](int f) {
    sources[f] = contents[f];
    norm_paths[f] = normalize_path(paths[f]);
    toks[f] = tokenize(sources[f]);
    names[f] = collect_type_names(toks[f]);
  });
  StrSet declared;
  for (int f = 0; f < n_files; f++)
    for (auto& name : names[f]) declared.insert(name);
  std::vector<std::vector<DeclNode>> per_file(n_files);
  parallel_for(n_files, [&](int f) {
    scan_tokens(norm_paths[f], toks[f], declared, &per_file[f]);
  });
  std::string out = "[";
  bool first = true;
  for (int f = 0; f < n_files; f++) {
    for (auto& node : per_file[f]) {
      if (!first) out += ",";
      first = false;
      append_node_json(node, &out);
    }
  }
  out += "]";
  char* buf = static_cast<char*>(malloc(out.size() + 1));
  memcpy(buf, out.data(), out.size() + 1);
  return buf;
}

// Pass 1 only: per-file declared type names as a JSON array of sorted
// string arrays. Lets the host-side decl cache compute the snapshot's
// declared-set hash without falling back to the Python tokenizer.
char* smn_type_names(const char** contents, int n_files) {
  std::vector<std::vector<std::string>> per_file(n_files);
  parallel_for(n_files, [&](int f) {
    std::string src(contents[f]);
    TokVec toks = tokenize(src);
    for (auto& name : collect_type_names(toks)) per_file[f].push_back(name);
    std::sort(per_file[f].begin(), per_file[f].end());
  });
  std::string out = "[";
  for (int f = 0; f < n_files; f++) {
    if (f) out += ",";
    out += "[";
    for (size_t k = 0; k < per_file[f].size(); k++) {
      if (k) out += ",";
      out += "\"";
      json_escape(per_file[f][k], &out);
      out += "\"";
    }
    out += "]";
  }
  out += "]";
  char* buf = static_cast<char*>(malloc(out.size() + 1));
  memcpy(buf, out.data(), out.size() + 1);
  return buf;
}

// Combined cold-path entry: one tokenize pass yields BOTH the per-file
// declared type names (for the host decl cache's keys) and the decl
// nodes — a fully-cold cached scan costs exactly one native pass.
// Returns {"names": [[...], ...], "nodes": [...]}.
char* smn_scan_with_names(const char** paths, const char** contents, int n_files) {
  std::vector<std::string> sources(n_files);
  std::vector<std::string> norm_paths(n_files);
  std::vector<TokVec> toks(n_files);
  std::vector<std::vector<std::string>> names(n_files);
  parallel_for(n_files, [&](int f) {
    sources[f] = contents[f];
    norm_paths[f] = normalize_path(paths[f]);
    toks[f] = tokenize(sources[f]);
    for (auto& name : collect_type_names(toks[f])) names[f].push_back(name);
    std::sort(names[f].begin(), names[f].end());
  });
  StrSet declared;
  for (int f = 0; f < n_files; f++)
    for (auto& name : names[f]) declared.insert(name);
  std::vector<std::vector<DeclNode>> per_file(n_files);
  parallel_for(n_files, [&](int f) {
    scan_tokens(norm_paths[f], toks[f], declared, &per_file[f]);
  });
  std::string out = "{\"names\":[";
  for (int f = 0; f < n_files; f++) {
    if (f) out += ",";
    out += "[";
    for (size_t k = 0; k < names[f].size(); k++) {
      if (k) out += ",";
      out += "\"";
      json_escape(names[f][k], &out);
      out += "\"";
    }
    out += "]";
  }
  out += "],\"nodes\":[";
  bool first = true;
  for (int f = 0; f < n_files; f++) {
    for (auto& node : per_file[f]) {
      if (!first) out += ",";
      first = false;
      append_node_json(node, &out);
    }
  }
  out += "]}";
  char* buf = static_cast<char*>(malloc(out.size() + 1));
  memcpy(buf, out.data(), out.size() + 1);
  return buf;
}

// Columnar op-log serializer — the native twin of
// semantic_merge_tpu_torch/ops/oplog_view.py OpStreamView.to_json(). The
// fused device path fetches op streams as int32 columns; this renders
// the canonical op-log JSON (the reference parity surface,
// semmerge/ops.py:106-121 shape) straight from those columns plus two
// node string tables, byte-identical to the Python serializer
// (fuzz-tested in tests/test_oplog_view.py).
//
//   kind   : n int32 diff kinds (0 rename, 1 move, 2 add, 3 delete)
//   a_slot : n int32 indices into the base node table (rename/move/delete)
//   b_slot : n int32 indices into the side node table (rename/move/add)
//   words  : n*4 uint32 op-id digest words; uuid hex = the words
//            rendered big-endian in order, dashes at 8/12/16/20
//   *_blob/*_offs: node tables — per node, 4 UTF-8 fields (symbolId,
//            addressId, name, file) as [offs[4i+k], offs[4i+k+1])
//            byte ranges of blob; offsets int64, 4*m+1 entries
//   prov   : the pre-rendered provenance JSON object (shared per stream)

static const char HEXD[] = "0123456789abcdef";

static inline void append_uuid(const uint32_t* w, std::string* out) {
  char buf[36];
  char hex[32];
  for (int k = 0; k < 4; k++) {
    uint32_t v = w[k];
    for (int j = 7; j >= 0; j--) { hex[k * 8 + j] = HEXD[v & 0xF]; v >>= 4; }
  }
  int p = 0;
  for (int i = 0; i < 32; i++) {
    if (i == 8 || i == 12 || i == 16 || i == 20) buf[p++] = '-';
    buf[p++] = hex[i];
  }
  out->append(buf, 36);
}

struct NodeTab {
  const char* blob;
  const int64_t* offs;
};

static inline void append_field(const NodeTab& t, int64_t node, int field,
                                std::string* out) {
  int64_t a = t.offs[node * 4 + field], b = t.offs[node * 4 + field + 1];
  const char* s = t.blob + a;
  int64_t len = b - a;
  // Fast path: no byte needs escaping (the overwhelming case for
  // identifiers/paths); single scan, bulk append.
  bool clean = true;
  for (int64_t i = 0; i < len; i++) {
    unsigned char c = (unsigned char)s[i];
    if (c < 0x20 || c == '"' || c == '\\') { clean = false; break; }
  }
  if (clean) { out->append(s, (size_t)len); return; }
  std::string tmp(s, (size_t)len);
  json_escape(tmp, out);
}

char* smn_oplog_json(int n,
                     const int32_t* kind, const int32_t* a_slot,
                     const int32_t* b_slot, const uint32_t* words,
                     const char* base_blob, const int64_t* base_offs,
                     const char* side_blob, const int64_t* side_offs,
                     const char* prov_json, int64_t* out_len) {
  NodeTab bt{base_blob, base_offs};
  NodeTab st{side_blob, side_offs};
  std::string prov(prov_json);
  std::string out;
  out.reserve((size_t)n * 420 + 2);
  out += "[";
  for (int i = 0; i < n; i++) {
    if (i) out += ",";
    out += "{\"id\":\"";
    append_uuid(words + (size_t)i * 4, &out);
    out += "\",\"schemaVersion\":1,\"type\":\"";
    int k = kind[i];
    int64_t a = a_slot[i], b = b_slot[i];
    switch (k) {
      case 0: {  // renameSymbol
        out += "renameSymbol\",\"target\":{\"symbolId\":\"";
        append_field(bt, a, 0, &out);
        out += "\",\"addressId\":\"";
        append_field(bt, a, 1, &out);
        out += "\"},\"params\":{\"oldName\":\"";
        append_field(bt, a, 2, &out);
        out += "\",\"newName\":\"";
        append_field(st, b, 2, &out);
        out += "\",\"file\":\"";
        append_field(st, b, 3, &out);
        out += "\"},\"guards\":{\"exists\":true,\"addressMatch\":\"";
        append_field(bt, a, 1, &out);
        out += "\"},\"effects\":{\"summary\":\"rename ";
        append_field(bt, a, 2, &out);
        out += "\xe2\x86\x92";  // U+2192 →
        append_field(st, b, 2, &out);
        out += "\"},\"provenance\":";
        break;
      }
      case 1: {  // moveDecl
        out += "moveDecl\",\"target\":{\"symbolId\":\"";
        append_field(bt, a, 0, &out);
        out += "\",\"addressId\":\"";
        append_field(bt, a, 1, &out);
        out += "\"},\"params\":{\"oldAddress\":\"";
        append_field(bt, a, 1, &out);
        out += "\",\"newAddress\":\"";
        append_field(st, b, 1, &out);
        out += "\",\"oldFile\":\"";
        append_field(bt, a, 3, &out);
        out += "\",\"newFile\":\"";
        append_field(st, b, 3, &out);
        out += "\"},\"guards\":{\"exists\":true,\"addressMatch\":\"";
        append_field(bt, a, 1, &out);
        out += "\"},\"effects\":{\"summary\":\"move ";
        append_field(bt, a, 1, &out);
        out += "\xe2\x86\x92";
        append_field(st, b, 1, &out);
        out += "\"},\"provenance\":";
        break;
      }
      case 2: {  // addDecl
        out += "addDecl\",\"target\":{\"symbolId\":\"";
        append_field(st, b, 0, &out);
        out += "\",\"addressId\":\"";
        append_field(st, b, 1, &out);
        out += "\"},\"params\":{\"file\":\"";
        append_field(st, b, 3, &out);
        out += "\"},\"guards\":{},\"effects\":{\"summary\":\"add decl\"},"
               "\"provenance\":";
        break;
      }
      default: {  // deleteDecl
        out += "deleteDecl\",\"target\":{\"symbolId\":\"";
        append_field(bt, a, 0, &out);
        out += "\",\"addressId\":\"";
        append_field(bt, a, 1, &out);
        out += "\"},\"params\":{\"file\":\"";
        append_field(bt, a, 3, &out);
        out += "\"},\"guards\":{},\"effects\":{\"summary\":\"delete decl\"},"
               "\"provenance\":";
        break;
      }
    }
    out += prov;
    out += "}";
  }
  out += "]";
  *out_len = (int64_t)out.size();
  char* buf = static_cast<char*>(malloc(out.size() + 1));
  memcpy(buf, out.data(), out.size() + 1);
  return buf;
}

void smn_free(char* p) { free(p); }

}  // extern "C"
