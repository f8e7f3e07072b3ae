"""Every host module that the port copied from the JAX package equals its
original but for import lines, the module docstring and a stated list of
functions or lines: any other edit to either file must be made to both.

Besides the functions listed, a few comment lines differ in one word or in
how they name a file of the reference implementation; they are listed by
a piece of text that both versions of the line share.  A copy listed with
an exact edit equals its original with that edit applied, byte for byte."""
import ast
import difflib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's BAM core counts the bytes it inflates and the records its
# region decodes answer from the scan's columns or walk, keeps the handle's
# thread count for its region decodes, inflates a scan window through the
# helper its region decodes share, keeps two more columns (each record's
# aligned bases and largest gap, in the scan and its cache) and has no
# BC_TIMING switch: the edit that turns the original into the port, as
# (text of the original, its replacement) pairs; each text occurs once in
# the original
_BAMCORE_CPP_EDIT = (
    ("// Exposed as a C ABI for ctypes; no Python headers required.\n",
     """// Exposed as a C ABI for ctypes; no Python headers required.
//
// Three process-wide counters of payload bytes inflated, read by
// bc_counters(): by the scan (scan_inflated_bytes), by region decodes
// (decode_inflated_bytes), and the part of the latter inflated on more
// than one thread (decode_pooled_bytes).  They live outside any handle,
// so they outlast bc_close, and count always (one relaxed add a window).
// Two more count the records of region decodes: those answered from the
// scan's columns (decode_column_records, one relaxed add a call) and those
// walked from inflated bytes (decode_walked_records, one a run walked).
"""),
    ("#include <algorithm>\n", "#include <algorithm>\n#include <atomic>\n"),
    ("\nconstexpr uint32_t kRefConsuming", """
std::atomic<int64_t> g_scan_inflated{0};
std::atomic<int64_t> g_decode_inflated{0};
std::atomic<int64_t> g_decode_pooled{0};
std::atomic<int64_t> g_decode_column{0};
std::atomic<int64_t> g_decode_walked{0};

constexpr uint32_t kRefConsuming"""),
    ("  dvec<int64_t> sa_len;\n\n",
     "  dvec<int64_t> sa_len;\n"
     "  dvec<int64_t> aligned;    // bases in the record's M/=/X ops\n"
     "  dvec<int64_t> max_gap;    // largest gap between consecutive such ops\n"
     "\n"),
    ("""  int64_t ref_len = 0;
  for (int ci = 0; ci < n_cigar; ci++) {
    uint32_t c;
    memcpy(&c, cig_p + 4 * ci, 4);
    if ((1u << (c & 0xF)) & kRefConsuming) ref_len += c >> 4;
  }
""", """  int64_t ref_len = 0;
  // the aligned-base count and the largest gap between consecutive
  // aligned ops, the gap measured as bc_del_gaps measures it
  int64_t aligned = 0, max_gap = 0, prev_blk_end = -1;
  for (int ci = 0; ci < n_cigar; ci++) {
    uint32_t c;
    memcpy(&c, cig_p + 4 * ci, 4);
    if ((1u << (c & 0xF)) & kAligned) {
      const int64_t bstart = pos + ref_len;
      if (prev_blk_end >= 0) {
        const int64_t gap = bstart - prev_blk_end;
        max_gap = std::max(max_gap, gap < 0 ? -gap : gap);
      }
      prev_blk_end = bstart + (c >> 4);
      aligned += c >> 4;
    }
    if ((1u << (c & 0xF)) & kRefConsuming) ref_len += c >> 4;
  }
"""),
    ("  bc->nm[gidx] = nmv;\n",
     "  bc->nm[gidx] = nmv;\n"
     "  bc->aligned[gidx] = aligned;\n"
     "  bc->max_gap[gidx] = max_gap;\n"),
    ("      ensure_size(bc->sa_off, new_n);\n",
     "      ensure_size(bc->sa_off, new_n);\n"
     "      ensure_size(bc->aligned, new_n);\n"
     "      ensure_size(bc->max_gap, new_n);\n"),
    ("constexpr uint32_t BCX_VERSION = 2;\n",
     "constexpr uint32_t BCX_VERSION = 3;\n"),
    ("       write_vec(f, bc->sa_len);\n",
     "       write_vec(f, bc->sa_len) && write_vec(f, bc->aligned) &&\n"
     "       write_vec(f, bc->max_gap);\n"),
    ("""       read_vec(f, bc->sa_len, mb);
  ok = ok && bc->name_off.size() == bc->flag.size() + 1 &&
       bc->sa_off.size() == bc->flag.size() &&
       bc->sa_len.size() == bc->flag.size();
""", """       read_vec(f, bc->sa_len, mb) && read_vec(f, bc->aligned, mb) &&
       read_vec(f, bc->max_gap, mb);
  ok = ok && bc->name_off.size() == bc->flag.size() + 1 &&
       bc->sa_off.size() == bc->flag.size() &&
       bc->sa_len.size() == bc->flag.size() &&
       bc->aligned.size() == bc->flag.size() &&
       bc->max_gap.size() == bc->flag.size();
"""),
    ("    bc->sa_len.clear();\n  }\n",
     "    bc->sa_len.clear();\n"
     "    bc->aligned.clear();\n"
     "    bc->max_gap.clear();\n"
     "  }\n"),
    ("const int64_t* bc_col_nm(BamCore* bc) { return bc->nm.data(); }\n",
     "const int64_t* bc_col_nm(BamCore* bc) { return bc->nm.data(); }\n"
     "const int64_t* bc_col_aligned(BamCore* bc) "
     "{ return bc->aligned.data(); }\n"
     "const int64_t* bc_col_max_gap(BamCore* bc) "
     "{ return bc->max_gap.data(); }\n"),
    ("  bool from_cache = false;   // record table loaded from a scan cache\n",
     "  bool from_cache = false;   // record table loaded from a scan cache\n"
     "  int nthreads = 1;          // threads a region decode inflates on\n"),
    ("""BamCore* bc_open(const char* path, int nthreads) {
  auto* bc = new BamCore();
  bc->path = path;
""", """BamCore* bc_open(const char* path, int nthreads) {
  auto* bc = new BamCore();
  bc->path = path;
  bc->nthreads = nthreads < 1 ? 1 : (nthreads > 64 ? 64 : nthreads);
"""),
    ("""                        int nthreads) {
  auto* bc = new BamCore();
  bc->path = path;
""", """                        int nthreads) {
  auto* bc = new BamCore();
  bc->path = path;
  bc->nthreads = nthreads < 1 ? 1 : (nthreads > 64 ? 64 : nthreads);
"""),
    ("""  Scanner sc(bc, nthreads);
  const bool timing = getenv("BC_TIMING") != nullptr;
  double t_win = 0, t_p1 = 0, t_p2 = 0, t_p3 = 0, t_drop = 0;
  auto now = []() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
  };
""", "  Scanner sc(bc, nthreads);\n"),
    ("bool scan_file(BamCore* bc, int nthreads) {\n",
     """// Inflate members[i], described by infos[i], to out + dst[i] for every
// member of infos, on nt threads: member i on thread i mod nt (nt 1: on
// the calling thread).  On failure *err is the error of the first thread
// that had one.
bool inflate_members(const std::vector<BlockInfo>& infos,
                     const std::vector<std::vector<uint8_t>>& members,
                     const int64_t* dst, uint8_t* out, int nt,
                     std::string* err) {
  const size_t k = infos.size();
  if (nt <= 1) {
    for (size_t i = 0; i < k; i++) {
      if (!inflate_block(members[i].data(), infos[i], out + dst[i], err)) {
        return false;
      }
    }
    return true;
  }
  std::string errs[64];
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++) {
    threads.emplace_back([&, t]() {
      for (size_t i = t; i < k; i += nt) {
        if (!inflate_block(members[i].data(), infos[i], out + dst[i],
                           &errs[t])) {
          return;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < nt; t++) {
    if (!errs[t].empty()) { *err = errs[t]; return false; }
  }
  return true;
}

bool scan_file(BamCore* bc, int nthreads) {
"""),
    ("""    // parallel inflate
    std::string errs[64];
    int nt = sc.nthreads > 64 ? 64 : sc.nthreads;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; t++) {
      threads.emplace_back([&, t]() {
        for (size_t i = t; i < infos.size(); i += nt) {
          if (!inflate_block(members[i].data(), infos[i],
                             sc.buf.data() + dst_off[i], &errs[t])) {
            return;
          }
        }
      });
    }
    for (auto& th : threads) th.join();
    for (int t = 0; t < nt; t++) {
      if (!errs[t].empty()) { bc->error = errs[t]; return false; }
    }
    return true;
""", """    // parallel inflate
    if (!inflate_members(infos, members, dst_off.data(), sc.buf.data(),
                         sc.nthreads, &bc->error)) {
      return false;
    }
    g_scan_inflated.fetch_add(total, std::memory_order_relaxed);
    return true;
"""),
    ("    double t0 = timing ? now() : 0;\n", ""),
    ("    if (timing) t_win += now() - t0;\n", ""),
    ("    if (timing) t0 = now();\n", ""),
    ("    if (timing) { t_p1 += now() - t0; t0 = now(); }\n", ""),
    ("      if (timing) { t_p2 += now() - t0; t0 = now(); }\n", ""),
    ("      if (timing) { t_p3 += now() - t0; t0 = now(); }\n", ""),
    (r"""    sc.drop_consumed(parse_gpos);
    if (timing) t_drop += now() - t0;
  }
  if (timing) {
    fprintf(stderr,
            "bc_scan timing: window=%.2fs p1=%.2fs p2=%.2fs "
            "merge=%.2fs drop=%.2fs\n", t_win, t_p1, t_p2, t_p3, t_drop);
  }
""", """    sc.drop_consumed(parse_gpos);
  }
"""),
    ("void bc_close(BamCore* bc) { delete bc; }\n",
     """// The process-wide counters, in this order: scan_inflated_bytes,
// decode_inflated_bytes, decode_pooled_bytes, decode_column_records,
// decode_walked_records.  Writes the first min(n, 5) into out and returns
// how many there are.
int bc_counters(int64_t* out, int n) {
  const int64_t v[5] = {g_scan_inflated.load(std::memory_order_relaxed),
                        g_decode_inflated.load(std::memory_order_relaxed),
                        g_decode_pooled.load(std::memory_order_relaxed),
                        g_decode_column.load(std::memory_order_relaxed),
                        g_decode_walked.load(std::memory_order_relaxed)};
  for (int i = 0; i < n && i < 5; i++) out[i] = v[i];
  return 5;
}

void bc_close(BamCore* bc) { delete bc; }
"""),
    ("""static double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

""", ""),
    ("""  const bool dbg = getenv("BC_TIMING") != nullptr;
  double t0 = dbg ? now_s() : 0;
""", ""),
    (r"""    if (dbg) { fprintf(stderr, "[bc_parse_sa] slot/split: %.3fs\n", now_s() - t0); t0 = now_s(); }
""", ""),
    (r"""  if (dbg) { fprintf(stderr, "[bc_parse_sa] read_len: %.3fs\n", now_s() - t0); t0 = now_s(); }
""", ""),
    (r"""  if (dbg) fprintf(stderr, "[bc_parse_sa] parse/emit[%d threads]: %.3fs\n",
                   nt, now_s() - t0);
""", ""),
)

# relative path -> the exact edit that turns the original into the port
EDITS = {"native/bamcore.cpp": _BAMCORE_CPP_EDIT}

# relative path -> sections that are the port's own, each from a line that
# starts with its first text up to the line that starts with its second:
# the port inflates a region's members on the handle's threads, and answers
# a coverage sum or a deletion-gap search from the scan's columns where it
# can, walking only the records they cannot answer
OWN_SECTIONS = {"native/bamcore.cpp": (
    ("// ---- region decode", "// ---- SA-tag chimera assembly"),
    ("int64_t bc_coverage_sum(", "int bc_coverage_profile("),
    ("int64_t bc_del_gaps(", "void bc_del_gaps_fetch("))}

# relative path -> (functions, classes or module-level names that may
# differ, substrings or patterns of other lines that may differ)
COPIES = {
    "constants.py": ((), ("global_names.py:9-25",)),
    "config.py": ((), ()),
    # the trace file hangs on the port's own package logger; the spans
    # and the counters are the port's own
    "tracing.py": (("setup_file_logging", "SpanRecord", "MAX_SPANS", "SPANS",
                    "_enabled", "_seq", "_lock", "enable", "disable", "last_seq",
                    "spans_since", "_record", "_NoSpan", "_NO_SPAN", "_Span",
                    "span", "COUNTERS", "_counts", "count", "counters"), ()),
    "sim.py": ((), ()),
    "io/__init__.py": ((), ()),
    "io/bgzf.py": ((), ()),
    "io/cnv.py": ((), ()),
    "io/bamwrite.py": ((), ()),
    # the native library is built by the port, not found beside the module;
    # the native region decodes run under spans
    "io/bam.py": (("_native_available", "coverage_sum", "coverage_profile",
                   "del_gap_alignments"), ()),
    "native/__init__.py": ((), ()),
    # the scan runs under a span; the library's counters are read
    "native/bamcore.py": (("_load", "scan_into", "COUNTERS", "counters"),
                          ("_SO_PATH",)),
    "native/walkenum.py": (("_load", "available"), ("_SO_PATH",)),
    "native/bamcore.cpp": None,
    "native/walkenum.cpp": ((), ("mirrors the Python",
                                 "mirroring the Python")),
    "native/Makefile": None,
    "ops/layout.py": ((), ()),
    # the native SA parse runs under a span
    "ops/chimera.py": (("collect_chimeras",), ()),
    # the device engine takes its match matrix from the port's kernel K9
    # (engines torch and cuda on a device, uint8 cells) where the original
    # goes to the Pallas kernel (engine pallas, interpret, int32 cells)
    "ops/breakpoints.py": (("cluster_breakpoints", "_cluster_group_device"),
                           ("# device-path group-size", "# modest (4096**2")),
    "graph/breakpoint_graph.py": ((), ()),
    "cycles/__init__.py": ((), ()),
    "cycles/candidates.py": ((), ("suboptimal and the decomposition",)),
    "cycles/eulerian.py": ((), ()),
    "cycles/path_constraints.py": ((), ()),
    "cycles/output.py": ((), ("our candidate pool can",)),
    # the walk enumerations and the MILP solves run under spans and count
    # the walks, path constraints and MILP sizes
    "cycles/decomposition.py": (("cycle_decomposition",
                                 "_solve_selection_milp"),
                                ("keeps the reference's model-size gate",
                                 "Per-amplicon decomposition")),
    "cycles/colgen.py": ((), ("cycle_decomposition.py:179-332",
                              "an admissible bound otherwise")),
    "cycles/refmodel.py": ((), ()),
    "annotations.py": ((), ()),
    "annotations_bushman.py": ((), ()),
    "seed.py": ((), ()),
    "cycle2bed.py": ((), ()),
    "hsr.py": ((), ()),
    "plot/__init__.py": ((), ()),
    "plot/plot_amplicons.py": ((), ()),
    "parallel/__init__.py": ((), ()),
    # the pipeline after the merge runs its device engines on ``device``
    "parallel/multihost.py": (("multihost_reconstruct_graphs",), ()),
}


# functions the port copied into a module it rewrote: (relative path,
# function) -> substrings of lines that may differ
FUNCTION_COPIES = {
    # one system, so ``auto`` is the numpy engine; the port's
    # ``_assign_solution`` names the device where the engines run
    ("graph/cn_solver.py", "compute_cn_hybrid"): (
        "_assign_solution(", "auto`` is the numpy engine"),
}


def _read(pkg, rel):
    with open(os.path.join(ROOT, pkg, rel)) as fh:
        return fh.read()


def _allowed_lines(rel: str, src: str, functions):
    if not rel.endswith(".py"):
        return set()
    tree = ast.parse(src)
    allowed = set()
    if tree.body and isinstance(tree.body[0], ast.Expr) \
            and isinstance(tree.body[0].value, ast.Constant):
        allowed.update(range(1, tree.body[0].end_lineno + 1))   # docstring
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name in functions:
            allowed.update(range(node.lineno, node.end_lineno + 1))
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id in functions
               for t in targets):
            allowed.update(range(node.lineno, node.end_lineno + 1))
    return allowed


def _apply_edit(rel: str, src: str) -> str:
    for old, new in EDITS.get(rel, ()):
        assert src.count(old) == 1, f"coral_tpu/{rel}: {old!r}"
        src = src.replace(old, new)
    return src


def _cut_own(rel: str, pkg: str, src: str) -> str:
    """``src`` with each section of OWN_SECTIONS[rel] left as its first
    line."""
    for first, last in OWN_SECTIONS.get(rel, ()):
        a, b = src.split("\n" + first), src.split("\n" + last)
        assert len(a) == 2 and len(b) == 2, f"{pkg}/{rel}: {first!r}"
        src = a[0] + "\n" + first + "\n" + last + b[1]
    return src


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_drift_guard(rel):
    src_j, src_t = _read("coral_tpu", rel), _read("coral_tpu_torch", rel)
    if COPIES[rel] is None:
        assert _cut_own(rel, "coral_tpu", _apply_edit(rel, src_j)) == \
            _cut_own(rel, "coral_tpu_torch", src_t)
        return
    functions, substrings = COPIES[rel]
    lines_j, lines_t = src_j.splitlines(), src_t.splitlines()
    ok_j = _allowed_lines(rel, src_j, functions)
    ok_t = _allowed_lines(rel, src_t, functions)

    def fine(line: str, lineno: int, ok) -> bool:
        s = line.strip()
        return (lineno in ok or not s
                or (rel.endswith(".py")
                    and s.startswith(("from ", "import ")))
                or any(sub in s for sub in substrings))

    bad = []
    sm = difflib.SequenceMatcher(None, lines_j, lines_t, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        bad += [f"coral_tpu/{rel}:{i + 1}: {lines_j[i]}"
                for i in range(i1, i2) if not fine(lines_j[i], i + 1, ok_j)]
        bad += [f"coral_tpu_torch/{rel}:{j + 1}: {lines_t[j]}"
                for j in range(j1, j2) if not fine(lines_t[j], j + 1, ok_t)]
    assert not bad, "\n".join(bad)
    assert "coral_tpu." not in "\n".join(
        ln for ln in lines_t if ln.strip().startswith(("from ", "import ")))


def _function_lines(src: str, name: str):
    (node,) = [n for n in ast.parse(src).body
               if isinstance(n, ast.FunctionDef) and n.name == name]
    return src.splitlines()[node.lineno - 1:node.end_lineno]


@pytest.mark.parametrize("rel,name", sorted(FUNCTION_COPIES))
def test_copied_function_drift_guard(rel, name):
    """A function copied into a rewritten module equals its original but
    for the listed lines: an edit to either must be made to both."""
    lines_j = _function_lines(_read("coral_tpu", rel), name)
    lines_t = _function_lines(_read("coral_tpu_torch", rel), name)
    subs = FUNCTION_COPIES[rel, name]
    bad = []
    sm = difflib.SequenceMatcher(None, lines_j, lines_t, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag != "equal":
            bad += [ln for ln in lines_j[i1:i2] + lines_t[j1:j2]
                    if not any(sub in ln for sub in subs)]
    assert not bad, "\n".join(bad)
    assert len(lines_t) > 10


def test_every_copy_is_guarded():
    """Each file of the port that has a namesake in the JAX package is
    either in the list above or one of the modules the port rewrote."""
    rewritten = {"__init__.py", "__main__.py", "cli.py", "reconstruct.py",
                 "graph/__init__.py", "graph/cn_solver.py", "ops/__init__.py",
                 "ops/pairs.py", "ops/scoring.py", "ops/coverage.py",
                 "ops/routing.py",
                 "parallel/mesh.py", "parallel/sharded.py",
                 "parallel/distributed.py"}
    found = set()
    top = os.path.join(ROOT, "coral_tpu_torch")
    for d, _, names in os.walk(top):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), top)
            if "__pycache__" in rel or rel.endswith((".so", ".pyc")):
                continue
            if os.path.exists(os.path.join(ROOT, "coral_tpu", rel)):
                found.add(rel)
    assert found - rewritten == set(COPIES)
