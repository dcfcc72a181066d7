/* Native host pipeline of krakenuniq_tpu_torch (module kuniq_native_torch).
 *
 * A copy of the JAX package's native/kuniq_native.cpp under its own module
 * name, built by krakenuniq_tpu_torch/_native_build.py. The card runs the
 * compute path; this extension keeps the host side off the Python
 * interpreter for the three byte-level hot loops:
 *   - parse_unit:   FASTA/FASTQ work-unit parsing into offset tables
 *   - encode_unit:  2-bit base encoding + ambiguity flags into the padded
 *                   (B, LB) device-feed arrays
 *   - kraken_lines: RLE hit-list formatting of the classifier output
 *                   (reference classify.cpp:826-861 semantics)
 *
 * Built as a C extension on the CPython and numpy C APIs alone.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Record {
  int64_t id_off, id_len;
  int64_t hdr_off, hdr_len;
  int64_t seq_off, seq_len;
  int64_t qual_off, qual_len;
};

// base code table: A/C/G/T (either case) -> 0..3, everything else ambiguous
static uint8_t CODE[256];
static uint8_t AMBIG[256];

void init_tables() {
  memset(CODE, 0, sizeof(CODE));
  memset(AMBIG, 1, sizeof(AMBIG));
  const char* bases = "ACGT";
  for (int i = 0; i < 4; i++) {
    CODE[(unsigned char)bases[i]] = (uint8_t)i;
    CODE[(unsigned char)tolower(bases[i])] = (uint8_t)i;
    AMBIG[(unsigned char)bases[i]] = 0;
    AMBIG[(unsigned char)tolower(bases[i])] = 0;
  }
}

inline int64_t line_end(const char* buf, int64_t pos, int64_t n) {
  if (pos >= n) return n;
  const char* nl = (const char*)memchr(buf + pos, '\n', (size_t)(n - pos));
  return nl ? (int64_t)(nl - buf) : n;
}

inline int64_t trim_cr(const char* buf, int64_t start, int64_t end) {
  while (end > start && (buf[end - 1] == '\r')) end--;
  return end;
}

/* parse_unit(buffer: bytes, fastq: bool) ->
 *   (n, int64 array [n, 8] of record offsets, concat_needed: bool)
 * FASTA sequences may span multiple lines; when they do, seq_off/len refer
 * to the FIRST line only and seq_len is negated as a marker (the Python
 * caller re-concatenates those rare records). Single-line records (the
 * overwhelmingly common case for reads) are fully described. */
PyObject* parse_unit(PyObject*, PyObject* args) {
  Py_buffer view;
  int fastq;
  if (!PyArg_ParseTuple(args, "y*p", &view, &fastq)) return nullptr;
  const char* buf = (const char*)view.buf;
  int64_t n = (int64_t)view.len;

  std::vector<Record> recs;
  recs.reserve(4096);
  int64_t pos = 0;
  bool multiline = false;

  if (fastq) {
    while (pos < n) {
      int64_t he = line_end(buf, pos, n);
      if (he == pos) break;  // blank line terminates
      if (buf[pos] != '@') break;
      Record r{};
      r.hdr_off = pos + 1;
      r.hdr_len = trim_cr(buf, r.hdr_off, he) - r.hdr_off;
      // id = up to first whitespace
      int64_t idend = r.hdr_off;
      while (idend < r.hdr_off + r.hdr_len && buf[idend] != ' ' && buf[idend] != '\t')
        idend++;
      r.id_off = r.hdr_off;
      r.id_len = idend - r.hdr_off;
      pos = he + 1;
      if (pos > n) pos = n;
      int64_t se = line_end(buf, pos, n);
      r.seq_off = pos;
      r.seq_len = trim_cr(buf, pos, se) - pos;
      pos = se + 1 > n ? n : se + 1;
      int64_t pe = line_end(buf, pos, n);  // '+' line
      pos = pe + 1 > n ? n : pe + 1;
      int64_t qe = line_end(buf, pos, n);
      r.qual_off = pos;
      r.qual_len = trim_cr(buf, pos, qe) - pos;
      pos = qe + 1;
      recs.push_back(r);
    }
  } else {
    while (pos < n) {
      if (buf[pos] != '>') break;
      int64_t he = line_end(buf, pos, n);
      Record r{};
      r.hdr_off = pos + 1;
      r.hdr_len = trim_cr(buf, r.hdr_off, he) - r.hdr_off;
      int64_t idend = r.hdr_off;
      while (idend < r.hdr_off + r.hdr_len && buf[idend] != ' ' && buf[idend] != '\t')
        idend++;
      r.id_off = r.hdr_off;
      r.id_len = idend - r.hdr_off;
      pos = he + 1;
      if (pos > n) pos = n;
      r.seq_off = pos;
      int64_t first_end = trim_cr(buf, pos, line_end(buf, pos, n));
      int64_t nlines = 0;
      while (pos < n && buf[pos] != '>') {
        pos = line_end(buf, pos, n) + 1;
        nlines++;
      }
      r.seq_len = first_end - r.seq_off;
      if (nlines > 1) {
        r.seq_len = -r.seq_len;  // marker: multi-line, caller handles
        multiline = true;
      }
      r.qual_off = 0;
      r.qual_len = 0;
      recs.push_back(r);
    }
  }
  PyBuffer_Release(&view);

  npy_intp dims[2] = {(npy_intp)recs.size(), 8};
  PyObject* arr = PyArray_SimpleNew(2, dims, NPY_INT64);
  if (!arr) return nullptr;
  memcpy(PyArray_DATA((PyArrayObject*)arr), recs.data(), recs.size() * sizeof(Record));
  return Py_BuildValue("(nNO)", (Py_ssize_t)recs.size(), arr,
                       multiline ? Py_True : Py_False);
}

/* encode_unit(buffer, offsets int64[n,8], lb, batch) ->
 *   (codes uint8[batch,lb], ambig bool[batch,lb], lengths int32[batch]) */
PyObject* encode_unit(PyObject*, PyObject* args) {
  Py_buffer view;
  PyArrayObject* offs;
  long lb, batch;
  if (!PyArg_ParseTuple(args, "y*O!ll", &view, &PyArray_Type, &offs, &lb, &batch))
    return nullptr;
  const char* buf = (const char*)view.buf;
  int64_t nrec = PyArray_DIM(offs, 0);
  const Record* recs = (const Record*)PyArray_DATA(offs);

  npy_intp cdims[2] = {batch, lb};
  npy_intp ldims[1] = {batch};
  PyArrayObject* codes = (PyArrayObject*)PyArray_ZEROS(2, cdims, NPY_UINT8, 0);
  PyArrayObject* ambig = (PyArrayObject*)PyArray_EMPTY(2, cdims, NPY_BOOL, 0);
  PyArrayObject* lengths = (PyArrayObject*)PyArray_ZEROS(1, ldims, NPY_INT32, 0);
  if (!codes || !ambig || !lengths) return nullptr;
  uint8_t* cp = (uint8_t*)PyArray_DATA(codes);
  uint8_t* ap = (uint8_t*)PyArray_DATA(ambig);
  int32_t* lp = (int32_t*)PyArray_DATA(lengths);
  memset(ap, 1, (size_t)(batch * lb));

  for (int64_t i = 0; i < nrec && i < batch; i++) {
    int64_t len = recs[i].seq_len;
    if (len < 0) len = -len;  // multi-line: first line only; caller fixed it up
    if (len > lb) len = lb;
    const char* s = buf + recs[i].seq_off;
    uint8_t* crow = cp + i * lb;
    uint8_t* arow = ap + i * lb;
    for (int64_t j = 0; j < len; j++) {
      unsigned char ch = (unsigned char)s[j];
      crow[j] = CODE[ch];
      arow[j] = AMBIG[ch];
    }
    lp[i] = (int32_t)len;
  }
  PyBuffer_Release(&view);
  return Py_BuildValue("(NNN)", codes, ambig, lengths);
}

/* encode_unit_packed(buffer, offsets int64[n,8], lb, batch) ->
 *   (codes uint32[batch, lb/16], ambig uint32[batch, lb/32], lengths int32[batch])
 * Bit-packed device feed: base j of a read occupies bits 2*(j%16) of codes
 * word j/16 and bit j%32 of ambig word j/32. Padding positions read as
 * ambiguous (ambig words start all-ones). lb must be a multiple of 32.
 * Cuts host->device bytes 5.3x vs encode_unit (3 bits/base vs 2 bytes/base),
 * which matters when the device link is bandwidth-bound. */
PyObject* encode_unit_packed(PyObject*, PyObject* args) {
  Py_buffer view;
  PyArrayObject* offs;
  long lb, batch;
  if (!PyArg_ParseTuple(args, "y*O!ll", &view, &PyArray_Type, &offs, &lb, &batch))
    return nullptr;
  if (lb % 32 != 0) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "lb must be a multiple of 32");
    return nullptr;
  }
  const char* buf = (const char*)view.buf;
  int64_t nrec = PyArray_DIM(offs, 0);
  const Record* recs = (const Record*)PyArray_DATA(offs);
  long lbw = lb / 16, lba = lb / 32;

  npy_intp cdims[2] = {batch, lbw};
  npy_intp adims[2] = {batch, lba};
  npy_intp ldims[1] = {batch};
  PyArrayObject* codes = (PyArrayObject*)PyArray_ZEROS(2, cdims, NPY_UINT32, 0);
  PyArrayObject* ambig = (PyArrayObject*)PyArray_EMPTY(2, adims, NPY_UINT32, 0);
  PyArrayObject* lengths = (PyArrayObject*)PyArray_ZEROS(1, ldims, NPY_INT32, 0);
  if (!codes || !ambig || !lengths) return nullptr;
  uint32_t* cp = (uint32_t*)PyArray_DATA(codes);
  uint32_t* ap = (uint32_t*)PyArray_DATA(ambig);
  int32_t* lp = (int32_t*)PyArray_DATA(lengths);
  memset(ap, 0xFF, (size_t)(batch * lba) * 4);

  for (int64_t i = 0; i < nrec && i < batch; i++) {
    int64_t len = recs[i].seq_len;
    if (len < 0) len = -len;
    if (len > lb) len = lb;
    const char* s = buf + recs[i].seq_off;
    uint32_t* crow = cp + i * lbw;
    uint32_t* arow = ap + i * lba;
    for (int64_t j = 0; j < len; j++) {
      unsigned char ch = (unsigned char)s[j];
      crow[j >> 4] |= (uint32_t)CODE[ch] << ((j & 15) * 2);
      if (!AMBIG[ch]) arow[j >> 5] &= ~(1u << (j & 31));
    }
    lp[i] = (int32_t)len;
  }
  PyBuffer_Release(&view);
  return Py_BuildValue("(NNN)", codes, ambig, lengths);
}

/* kraken_lines(ids: bytes (concatenated), id_off int64[n], id_len int64[n],
 *              calls uint32[n], seq_lens int32[n], n_kmers int32[n],
 *              taxa uint32[n, W], ambig uint8(bool)[n, W],
 *              quick: bool, hits int32[n], only_classified: bool) -> bytes
 * Formats classify.cpp:980-1010 output lines with the RLE hit list. */
PyObject* kraken_lines(PyObject*, PyObject* args) {
  Py_buffer ids;
  PyArrayObject *id_off, *id_len, *calls, *seq_lens, *n_kmers, *taxa, *ambig, *hits;
  int quick, only_classified;
  if (!PyArg_ParseTuple(args, "y*O!O!O!O!O!O!O!pO!p", &ids, &PyArray_Type, &id_off,
                        &PyArray_Type, &id_len, &PyArray_Type, &calls, &PyArray_Type,
                        &seq_lens, &PyArray_Type, &n_kmers, &PyArray_Type, &taxa,
                        &PyArray_Type, &ambig, &quick, &PyArray_Type, &hits,
                        &only_classified))
    return nullptr;

  int64_t n = PyArray_DIM(calls, 0);
  int64_t w = PyArray_DIM(taxa, 1);
  const char* idbuf = (const char*)ids.buf;
  const int64_t* ioff = (const int64_t*)PyArray_DATA(id_off);
  const int64_t* ilen = (const int64_t*)PyArray_DATA(id_len);
  const uint32_t* cp = (const uint32_t*)PyArray_DATA(calls);
  const int32_t* slp = (const int32_t*)PyArray_DATA(seq_lens);
  const int32_t* nkp = (const int32_t*)PyArray_DATA(n_kmers);
  const uint32_t* tp = (const uint32_t*)PyArray_DATA(taxa);
  const uint8_t* ap = (const uint8_t*)PyArray_DATA(ambig);
  const int32_t* hp = (const int32_t*)PyArray_DATA(hits);

  std::string out;
  out.reserve((size_t)n * 48);
  char tmp[64];

  for (int64_t i = 0; i < n; i++) {
    uint32_t call = cp[i];
    if (!call && only_classified) continue;
    out += call ? "C\t" : "U\t";
    out.append(idbuf + ioff[i], (size_t)ilen[i]);
    int len = snprintf(tmp, sizeof(tmp), "\t%u\t%d\t", call, slp[i]);
    out.append(tmp, (size_t)len);
    if (quick) {
      len = snprintf(tmp, sizeof(tmp), "Q:%d", hp[i]);
      out.append(tmp, (size_t)len);
    } else {
      int32_t nk = nkp[i];
      if (nk <= 0) {
        out += "0:0";
      } else {
        const uint32_t* trow = tp + i * w;
        const uint8_t* arow = ap + i * w;
        int64_t last_code = arow[0] ? -1 : (int64_t)trow[0];
        int64_t count = 1;
        for (int32_t j = 1; j < nk; j++) {
          int64_t code = arow[j] ? -1 : (int64_t)trow[j];
          if (code == last_code) {
            count++;
          } else {
            if (last_code >= 0)
              len = snprintf(tmp, sizeof(tmp), "%lld:%lld ", (long long)last_code,
                             (long long)count);
            else
              len = snprintf(tmp, sizeof(tmp), "A:%lld ", (long long)count);
            out.append(tmp, (size_t)len);
            count = 1;
            last_code = code;
          }
        }
        if (last_code >= 0)
          len = snprintf(tmp, sizeof(tmp), "%lld:%lld", (long long)last_code,
                         (long long)count);
        else
          len = snprintf(tmp, sizeof(tmp), "A:%lld", (long long)count);
        out.append(tmp, (size_t)len);
      }
    }
    out += '\n';
  }
  PyBuffer_Release(&ids);
  return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
}


/* kraken_lines_rle(ids: bytes, id_off int64[n], id_len int64[n],
 *                  packed uint32[n, cols], R (even),
 *                  seq_lens int32[n],
 *                  quick, only_classified,
 *                  overflow_idx int64[m], overflow_lines: list[bytes],
 *                  dense: bool, k: int, taxid_table: uint32[T] or None)
 * Wide row layout (dense=0; 60B/read at R=8, sized for a bandwidth-bound
 * device link): run_vals(R u32) | lens2(R/2 u32: two u16 per word, lo half =
 * even run; each u16 = run_len(15 bits) | ambig<<15) | call | n_kmers |
 * (hits<<16 | n_runs).
 * Dense row layout (dense=1; 40B/read at R=8): R run words of
 * dense_taxon<<16 | ambig<<15 | run_len, then call, then hits<<16 | n_runs;
 * dense ids map to taxids through taxid_table and n_kmers = max(0,
 * seq_len - (k-1)).  Overflow rows (n_runs > R) take their pre-rendered
 * line from overflow_lines (matched by position in overflow_idx). */
PyObject* kraken_lines_rle(PyObject*, PyObject* args) {
  Py_buffer ids;
  PyArrayObject *id_off, *id_len, *packed, *seq_lens, *ov_idx;
  long R, kk;
  int quick, only_classified, dense;
  PyObject* ov_lines;
  PyObject* table_obj;
  if (!PyArg_ParseTuple(args, "y*O!O!O!lO!ppO!OplO", &ids, &PyArray_Type, &id_off,
                        &PyArray_Type, &id_len, &PyArray_Type, &packed, &R,
                        &PyArray_Type, &seq_lens, &quick, &only_classified,
                        &PyArray_Type, &ov_idx, &ov_lines, &dense, &kk, &table_obj))
    return nullptr;
  const uint32_t* table = nullptr;
  int64_t table_n = 0;
  if (dense) {
    if (!PyArray_Check(table_obj)) {
      PyErr_SetString(PyExc_TypeError, "dense mode needs a taxid_table array");
      return nullptr;
    }
    table = (const uint32_t*)PyArray_DATA((PyArrayObject*)table_obj);
    table_n = PyArray_DIM((PyArrayObject*)table_obj, 0);
  }
  int64_t n = PyArray_DIM(packed, 0);
  int64_t stride = PyArray_DIM(packed, 1);
  const char* idbuf = (const char*)ids.buf;
  const int64_t* ioff = (const int64_t*)PyArray_DATA(id_off);
  const int64_t* ilen = (const int64_t*)PyArray_DATA(id_len);
  const uint32_t* pk = (const uint32_t*)PyArray_DATA(packed);
  const int32_t* slp = (const int32_t*)PyArray_DATA(seq_lens);
  const int64_t* ovp = (const int64_t*)PyArray_DATA(ov_idx);
  int64_t n_ov = PyArray_DIM(ov_idx, 0);
  int64_t ov_pos = 0;

  std::string out;
  out.reserve((size_t)n * 48);
  char tmp[64];
  const long META = dense ? R : R + R / 2;
  const int compact = dense && !quick;  // one meta word: call_dense<<16|n_runs
  for (int64_t i = 0; i < n; i++) {
    const uint32_t* row = pk + i * stride;
    uint32_t call;
    uint32_t n_kmers, hits = 0, n_runs;
    if (compact) {
      uint32_t mw = row[R];
      uint32_t cd = mw >> 16;
      call = cd < (uint32_t)table_n ? table[cd] : 0u;
      n_runs = mw & 0xFFFFu;
      int32_t nk = slp[i] - (int32_t)(kk - 1);
      n_kmers = nk > 0 ? (uint32_t)nk : 0u;
    } else if (dense) {
      call = row[META];
      int32_t nk = slp[i] - (int32_t)(kk - 1);
      n_kmers = nk > 0 ? (uint32_t)nk : 0u;
      hits = row[META + 1] >> 16;
      n_runs = row[META + 1] & 0xFFFFu;
    } else {
      call = row[META];
      n_kmers = row[META + 1];
      hits = row[META + 2] >> 16;
      n_runs = row[META + 2] & 0xFFFFu;
    }
    if (ov_pos < n_ov && ovp[ov_pos] == i) {
      // pre-rendered overflow line (consume it even when suppressed below)
      PyObject* line = PyList_GetItem(ov_lines, (Py_ssize_t)ov_pos);
      ov_pos++;
      if (!call && only_classified) continue;
      if (line && PyBytes_Check(line))
        out.append(PyBytes_AS_STRING(line), (size_t)PyBytes_GET_SIZE(line));
      continue;
    }
    if (!call && only_classified) continue;
    out += call ? "C\t" : "U\t";
    out.append(idbuf + ioff[i], (size_t)ilen[i]);
    int len = snprintf(tmp, sizeof(tmp), "\t%u\t%d\t", call, slp[i]);
    out.append(tmp, (size_t)len);
    if (quick) {
      len = snprintf(tmp, sizeof(tmp), "Q:%u", hits);
      out.append(tmp, (size_t)len);
    } else if (n_kmers == 0 || n_runs == 0) {
      out += "0:0";
    } else {
      for (uint32_t j = 0; j < n_runs && (long)j < R; j++) {
        uint32_t v, amb, l;
        if (dense) {
          uint32_t wd = row[j];
          uint32_t d = wd >> 16;
          v = d < (uint32_t)table_n ? table[d] : 0u;
          amb = (wd >> 15) & 1u;
          l = wd & 0x7FFFu;
        } else {
          v = row[j];
          uint32_t lw = (row[R + j / 2] >> ((j & 1) * 16)) & 0xFFFFu;
          amb = lw >> 15;
          l = lw & 0x7FFFu;
        }
        if (j) out += ' ';
        if (amb)
          len = snprintf(tmp, sizeof(tmp), "A:%u", l);
        else
          len = snprintf(tmp, sizeof(tmp), "%u:%u", v, l);
        out.append(tmp, (size_t)len);
      }
    }
    out += '\n';
  }
  PyBuffer_Release(&ids);
  return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
}

/* ------------------------------------------------------------------------
 * extract_kmer_bins(seq: bytes, k, nt, xor_mask)
 *   -> (kmers u64[cap], bins u64[cap], count)   [callers slice to count]
 *
 * One rolling pass over a sequence producing, for every valid k-mer window
 * (KmerScanner semantics, krakenutil.cpp:239-278: any non-ACGT byte poisons
 * every window containing it):
 *   - the canonical k-mer (min of forward and reverse-complement,
 *     krakendb.cpp:238-246), and
 *   - its scrambled-minimizer bin (krakendb.cpp:182-215): the minimum over
 *     the k-nt+1 m-mer windows of xor_mask ^ canonical(m-mer).
 *
 * The bin is strand-independent (canonical(rc(m)) == canonical(m) and the
 * m-mer window set of the reverse complement is the reversed, complemented
 * window set), so it is computed over the FORWARD m-mer stream with a
 * monotonic-deque sliding-window minimum -- O(1) amortized per base, vs the
 * numpy fallback's (k-nt+1) full-array passes (utils/bits.py bin_key).
 * Replaces the DB builder's per-pair numpy binning (build/db_build.py),
 * which measured ~2.3 us/k-mer; this loop runs ~100x faster.
 */
PyObject* extract_kmer_bins(PyObject*, PyObject* args) {
  Py_buffer view;
  int k, nt;
  unsigned long long xor_mask_in;
  if (!PyArg_ParseTuple(args, "y*iiK", &view, &k, &nt, &xor_mask_in))
    return nullptr;
  const uint8_t* seq = (const uint8_t*)view.buf;
  const int64_t n = (int64_t)view.len;
  if (k < 2 || k > 31 || nt < 1 || nt >= k) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "need 2 <= k <= 31, 1 <= nt < k");
    return nullptr;
  }
  const uint64_t kmask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  const uint64_t mmask = (1ull << (2 * nt)) - 1;
  const uint64_t xm = xor_mask_in & mmask;
  const int w = k - nt + 1;  // m-mer windows per k-mer

  // fill numpy arrays directly (no vector + copy); slice to count at return
  npy_intp cap[1] = {n >= k ? (npy_intp)(n - k + 1) : 0};
  PyArrayObject* k_arr = (PyArrayObject*)PyArray_SimpleNew(1, cap, NPY_UINT64);
  PyArrayObject* b_arr = (PyArrayObject*)PyArray_SimpleNew(1, cap, NPY_UINT64);
  if (!k_arr || !b_arr) {
    PyBuffer_Release(&view);
    Py_XDECREF(k_arr);
    Py_XDECREF(b_arr);
    return nullptr;
  }
  uint64_t* out_k = (uint64_t*)PyArray_DATA(k_arr);
  uint64_t* out_b = (uint64_t*)PyArray_DATA(b_arr);
  int64_t cnt = 0;
  // monotonic deque over the canonical-m-mer-xor stream: power-of-two ring
  // of (value, end-position) with nondecreasing values front to back
  int dq_cap = 2;
  while (dq_cap < w + 1) dq_cap <<= 1;
  const int dq_mask = dq_cap - 1;
  std::vector<uint64_t> dq_val((size_t)dq_cap);
  std::vector<int64_t> dq_pos((size_t)dq_cap);
  int64_t dq_head = 0, dq_tail = 0;  // [head, tail), monotonically increasing

  uint64_t fwd_k = 0, rc_k = 0;  // k-mer registers
  uint64_t fwd_m = 0, rc_m = 0;  // m-mer registers
  const int rc_k_shift = 2 * (k - 1);
  const int rc_m_shift = 2 * (nt - 1);
  int64_t last_ambig = -1;

  for (int64_t i = 0; i < n; i++) {
    const uint8_t b = seq[i];
    const uint64_t c = CODE[b];
    if (AMBIG[b]) last_ambig = i;
    fwd_k = ((fwd_k << 2) | c) & kmask;
    rc_k = (rc_k >> 2) | ((3ull - c) << rc_k_shift);
    fwd_m = ((fwd_m << 2) | c) & mmask;
    rc_m = (rc_m >> 2) | ((3ull - c) << rc_m_shift);
    if (i >= nt - 1) {
      // canonical m-mer ending at i, xor-scrambled
      const uint64_t cm = fwd_m < rc_m ? fwd_m : rc_m;
      const uint64_t cand = xm ^ cm;
      while (dq_tail != dq_head && dq_val[(dq_tail - 1) & dq_mask] >= cand)
        dq_tail--;
      dq_val[dq_tail & dq_mask] = cand;
      dq_pos[dq_tail & dq_mask] = i;
      dq_tail++;
      // evict m-mers that ended before the current k-mer window
      while (dq_pos[dq_head & dq_mask] <= i - w) dq_head++;
    }
    if (i >= k - 1 && last_ambig <= i - k) {
      out_k[cnt] = fwd_k < rc_k ? fwd_k : rc_k;
      out_b[cnt] = dq_val[dq_head & dq_mask];
      cnt++;
    }
  }
  PyBuffer_Release(&view);
  PyObject* out =
      Py_BuildValue("(OOn)", (PyObject*)k_arr, (PyObject*)b_arr, (Py_ssize_t)cnt);
  Py_DECREF(k_arr);
  Py_DECREF(b_arr);
  return out;
}

/* ------------------------------------------------------------------------
 * chd_place(hashes u64[n], lr, lg, seed, max_attempts)
 *   -> (row_of i32[n], col_of i8[n], disp u32[2^lg])  or None on failure
 *
 * Host-side placement for the one-gather displaced-bucket table
 * (krakenuniq_tpu_torch/db/hash_table.py module doc): every key's row is
 *     row = (p + d0 + d1*q) mod 2^lr
 * with p = top lr bits of the key hash, (d0, d1) the 16+16-bit displacement
 * of bucket g(r), and q a mix of the remainder r. Buckets are placed
 * largest-first (classic compressed hash-and-displace); per bucket,
 * displacement candidates are screened against a packed free-slot bitmap
 * (cache-resident: nrows/8 bytes) before the exact occupancy pass, which
 * also catches the birthday-rare within-bucket row collisions. Sequential
 * first-success search keeps total probed slots near the information-
 * theoretic minimum -- the vectorized numpy placement in db/hash_table.py
 * evaluates whole candidate windows instead and runs ~5-8x slower.
 */
static inline uint64_t fmix64_plus1(uint64_t k) {
  // matches krakenuniq_tpu_torch.utils.bits.murmur3_finalizer (key+1 first)
  k += 1;
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDull;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ull;
  k ^= k >> 33;
  return k;
}

PyObject* chd_place(PyObject*, PyObject* args) {
  PyArrayObject* hashes_arr;
  long lr, lg, seed, max_attempts;
  if (!PyArg_ParseTuple(args, "O!llll", &PyArray_Type, &hashes_arr, &lr, &lg,
                        &seed, &max_attempts))
    return nullptr;
  if (PyArray_TYPE(hashes_arr) != NPY_UINT64 || PyArray_NDIM(hashes_arr) != 1 ||
      !PyArray_IS_C_CONTIGUOUS(hashes_arr)) {
    PyErr_SetString(PyExc_TypeError, "hashes must be contiguous uint64[n]");
    return nullptr;
  }
  if (lr < 2 || lr > 30 || lg < 2 || lg > lr) {
    PyErr_SetString(PyExc_ValueError, "need 2 <= lg <= lr <= 30");
    return nullptr;
  }
  const int64_t n = (int64_t)PyArray_DIM(hashes_arr, 0);
  const uint64_t* h = (const uint64_t*)PyArray_DATA(hashes_arr);
  const uint32_t nrows = 1u << lr;
  const uint32_t m = 1u << lg;
  const uint32_t rowmask = nrows - 1;
  const uint64_t GOLDEN = 0x9E3779B97F4A7C15ull;
  const uint64_t C2 = 0xC2B2AE3D27D4EB4Full;

  npy_intp dn = (npy_intp)n, dm = (npy_intp)m;
  PyArrayObject* row_of =
      (PyArrayObject*)PyArray_SimpleNew(1, &dn, NPY_INT32);
  PyArrayObject* col_of = (PyArrayObject*)PyArray_SimpleNew(1, &dn, NPY_INT8);
  PyArrayObject* disp_arr =
      (PyArrayObject*)PyArray_ZEROS(1, &dm, NPY_UINT32, 0);
  if (!row_of || !col_of || !disp_arr) {
    Py_XDECREF(row_of);
    Py_XDECREF(col_of);
    Py_XDECREF(disp_arr);
    return nullptr;
  }
  int32_t* rowp = (int32_t*)PyArray_DATA(row_of);
  int8_t* colp = (int8_t*)PyArray_DATA(col_of);
  uint32_t* disp = (uint32_t*)PyArray_DATA(disp_arr);

  bool ok_all = true;
  Py_BEGIN_ALLOW_THREADS {
    // per-key fields
    std::vector<uint32_t> p(n), q(n);
    std::vector<uint32_t> g(n);
    for (int64_t i = 0; i < n; i++) {
      uint64_t hi = h[i];
      uint64_t r = (lr == 0) ? hi : (hi & ((~0ull) >> lr));
      p[i] = (uint32_t)(hi >> (64 - lr));
      g[i] = (uint32_t)((r * GOLDEN) >> (64 - lg));
      q[i] = (uint32_t)((r * C2) >> (64 - lr));
    }
    // counting sort key ids by bucket
    std::vector<uint32_t> bcnt(m + 1, 0);
    for (int64_t i = 0; i < n; i++) bcnt[g[i] + 1]++;
    uint32_t maxsz = 0;
    for (uint32_t b = 0; b < m; b++)
      if (bcnt[b + 1] > maxsz) maxsz = bcnt[b + 1];
    std::vector<uint32_t> bstart(m + 1, 0);
    for (uint32_t b = 0; b < m; b++) bstart[b + 1] = bstart[b] + bcnt[b + 1];
    std::vector<uint32_t> order(n);
    {
      std::vector<uint32_t> cur(bstart.begin(), bstart.end() - 1);
      for (int64_t i = 0; i < n; i++) order[cur[g[i]]++] = (uint32_t)i;
    }
    // bucket ids ordered by size descending (counting sort over sizes)
    std::vector<uint32_t> scnt(maxsz + 2, 0);
    for (uint32_t b = 0; b < m; b++) scnt[bcnt[b + 1]]++;
    std::vector<uint32_t> sstart(maxsz + 2, 0);
    // descending: size s block starts after all larger sizes
    {
      uint32_t acc = 0;
      for (int64_t s = maxsz; s >= 0; s--) {
        sstart[s] = acc;
        acc += scnt[s];
      }
    }
    std::vector<uint32_t> border(m);
    {
      std::vector<uint32_t> cur(sstart);
      for (uint32_t b = 0; b < m; b++) border[cur[bcnt[b + 1]]++] = b;
    }
    // occupancy + packed free bitmap
    std::vector<uint8_t> occ(nrows, 0);
    std::vector<uint64_t> freebits((nrows + 63) / 64, ~0ull);
    std::vector<uint32_t> tmprows(maxsz ? maxsz : 1);

    for (uint32_t bi = 0; bi < m && ok_all; bi++) {
      uint32_t b = border[bi];
      uint32_t sz = bcnt[b + 1];
      if (sz == 0) break;  // size-0 block is last in descending order
      const uint32_t* kids = &order[bstart[b]];
      uint64_t base = ((uint64_t)b << 24) + (uint64_t)seed * 0x9E3779B9ull;
      long t = 0;
      for (; t < max_attempts; t++) {
        uint64_t dmix = fmix64_plus1(base + (uint64_t)t);
        uint32_t d0 = (uint32_t)(dmix & 0xFFFF);
        uint32_t d1 = (uint32_t)((dmix >> 16) & 0xFFFF);
        // bitmap screen
        bool ok = true;
        for (uint32_t j = 0; j < sz; j++) {
          uint32_t i = kids[j];
          uint32_t row = (p[i] + d0 + d1 * q[i]) & rowmask;
          if (!((freebits[row >> 6] >> (row & 63)) & 1ull)) {
            ok = false;
            break;
          }
        }
        if (!ok) continue;
        // exact pass with rollback (catches within-bucket row collisions)
        uint32_t placed = 0;
        for (uint32_t j = 0; j < sz; j++) {
          uint32_t i = kids[j];
          uint32_t row = (p[i] + d0 + d1 * q[i]) & rowmask;
          if (occ[row] >= 2) {
            ok = false;
            break;
          }
          colp[i] = (int8_t)occ[row];
          occ[row]++;
          rowp[i] = (int32_t)row;
          tmprows[placed++] = row;
        }
        if (!ok) {
          for (uint32_t j = 0; j < placed; j++) occ[tmprows[j]]--;
          continue;
        }
        for (uint32_t j = 0; j < placed; j++) {
          uint32_t row = tmprows[j];
          if (occ[row] >= 2)
            freebits[row >> 6] &= ~(1ull << (row & 63));
        }
        disp[b] = (d1 << 16) | d0;
        break;
      }
      if (t == max_attempts) ok_all = false;
    }
  }
  Py_END_ALLOW_THREADS;
  if (!ok_all) {
    Py_DECREF(row_of);
    Py_DECREF(col_of);
    Py_DECREF(disp_arr);
    Py_RETURN_NONE;
  }
  PyObject* out = PyTuple_Pack(3, (PyObject*)row_of, (PyObject*)col_of,
                               (PyObject*)disp_arr);
  Py_DECREF(row_of);
  Py_DECREF(col_of);
  Py_DECREF(disp_arr);
  return out;
}

PyMethodDef methods[] = {
    {"chd_place", chd_place, METH_VARARGS,
     "Displaced-bucket (CHD) hash placement for the one-gather table"},
    {"parse_unit", parse_unit, METH_VARARGS, "Parse a FASTA/FASTQ work unit"},
    {"encode_unit", encode_unit, METH_VARARGS, "2-bit encode parsed records"},
    {"encode_unit_packed", encode_unit_packed, METH_VARARGS,
     "bit-packed (3 bits/base) encode of parsed records"},
    {"kraken_lines", kraken_lines, METH_VARARGS, "Format kraken output lines"},
    {"kraken_lines_rle", kraken_lines_rle, METH_VARARGS,
     "Format kraken output lines from device RLE runs"},
    {"extract_kmer_bins", extract_kmer_bins, METH_VARARGS,
     "Canonical k-mers + scrambled-minimizer bins, one rolling pass"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "kuniq_native_torch", "native host pipeline", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_kuniq_native_torch(void) {
  import_array();
  init_tables();
  PyObject* mod = PyModule_Create(&moduledef);
  if (mod) PyModule_AddIntConstant(mod, "API_VERSION", 6);
  return mod;
}
