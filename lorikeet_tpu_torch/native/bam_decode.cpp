// BAM decoding (host-native I/O hot path): BGZF block inflation + columnar
// record parsing.
//
// Role parity: the reference reads BAMs through rust-htslib (C htslib,
// reference/src/bam_parsing/bam_generator.rs:19-77).  This module is
// the equivalent native layer of this build: it turns a BAM file into
// flat columnar arrays the Python data model wraps zero-copy-ish (one copy
// into numpy), so the per-record Python loop disappears.
//
// Exported C ABI (ctypes):
//   bgzf_inflate(path) -> malloc'd whole uncompressed stream
//   bam_parse(buf, len, rec_off) -> BamColumns* (columnar arrays)
//   bam_columns_free(cols), bam_buffer_free(ptr)

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// nibble -> ASCII base (SAM spec 4.2.3)
const char SEQ_NT[17] = "=ACMGRSVTWYHKDBN";

bool inflate_block(const uint8_t* src, size_t src_len, std::vector<uint8_t>& out,
                   size_t* consumed) {
  // parse gzip member header to find BSIZE (BGZF extra field)
  if (src_len < 18 || src[0] != 0x1f || src[1] != 0x8b) return false;
  uint16_t xlen = src[10] | (src[11] << 8);
  size_t p = 12, end = 12 + xlen;
  if (end > src_len) return false;
  size_t bsize = 0;
  while (p + 4 <= end) {
    uint8_t si1 = src[p], si2 = src[p + 1];
    uint16_t slen = src[p + 2] | (src[p + 3] << 8);
    if (si1 == 66 && si2 == 67 && slen == 2) {
      bsize = (size_t)(src[p + 4] | (src[p + 5] << 8)) + 1;
    }
    p += 4 + slen;
  }
  if (bsize == 0 || bsize > src_len) return false;
  // ISIZE: last 4 bytes of the member
  uint32_t isize;
  std::memcpy(&isize, src + bsize - 4, 4);
  size_t old = out.size();
  out.resize(old + isize);
  if (isize > 0) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return false;
    zs.next_in = const_cast<uint8_t*>(src + end);
    zs.avail_in = (uInt)(bsize - end - 8);
    zs.next_out = out.data() + old;
    zs.avail_out = isize;
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (ret != Z_STREAM_END) return false;
  }
  *consumed = bsize;
  return true;
}

}  // namespace

extern "C" {

struct BamColumns {
  int64_t n;            // number of records
  int32_t* tid;
  int32_t* pos;
  int32_t* mapq;
  int32_t* flag;
  int32_t* mate_tid;
  int32_t* mate_pos;
  int32_t* tlen;
  int32_t* ref_len;     // reference bases consumed by the CIGAR
  int32_t* intrinsic;   // per-record filter bits: 1=refskip op,
                        // 2=consecutive indels, 4=starts/ends with deletion
                        // (ignoring clips), 8=cigar query len != l_seq,
                        // 16=zero reference length
  int64_t* name_off;    // [n+1] offsets into names
  int64_t* cigar_off;   // [n+1] offsets (in uint32 units) into cigars
  int64_t* seq_off;     // [n+1] offsets into seq/qual
  int64_t* tag_off;     // [n+1] offsets into tags (raw BAM tag bytes)
  char* names;
  uint32_t* cigars;     // packed (len<<4)|op
  uint8_t* seq;         // ASCII bases
  uint8_t* qual;
  uint8_t* tags;
};

// Inflate an entire BGZF file; returns malloc'd buffer (caller frees via
// bam_buffer_free) and writes its length.  NULL on error.
uint8_t* bgzf_inflate(const char* path, int64_t* out_len) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return nullptr;
  std::fseek(fh, 0, SEEK_END);
  long fsize = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  std::vector<uint8_t> raw((size_t)fsize);
  if (fsize > 0 && std::fread(raw.data(), 1, (size_t)fsize, fh) != (size_t)fsize) {
    std::fclose(fh);
    return nullptr;
  }
  std::fclose(fh);

  std::vector<uint8_t> out;
  out.reserve(raw.size() * 3);
  size_t p = 0;
  while (p < raw.size()) {
    size_t consumed = 0;
    if (!inflate_block(raw.data() + p, raw.size() - p, out, &consumed)) {
      return nullptr;
    }
    p += consumed;
  }
  uint8_t* buf = (uint8_t*)std::malloc(out.size() ? out.size() : 1);
  std::memcpy(buf, out.data(), out.size());
  *out_len = (int64_t)out.size();
  return buf;
}

void bam_buffer_free(uint8_t* p) { std::free(p); }

// Parse the record section of an uncompressed BAM stream (starting at
// rec_off) into columnar arrays.  Returns NULL on malformed input.
BamColumns* bam_parse(const uint8_t* buf, int64_t len, int64_t rec_off) {
  std::vector<int32_t> tid, pos, mapq, flag, mtid, mpos, tlen, rlen, intrinsic;
  std::vector<int64_t> name_off{0}, cigar_off{0}, seq_off{0}, tag_off{0};
  std::vector<char> names;
  std::vector<uint32_t> cigars;
  std::vector<uint8_t> seq, qual, tags;

  int64_t p = rec_off;
  while (p + 4 <= len) {
    uint32_t block_size;
    std::memcpy(&block_size, buf + p, 4);
    int64_t rp = p + 4, rend = p + 4 + block_size;
    if (rend > len || block_size < 32) return nullptr;
    int32_t v[8];
    std::memcpy(v, buf + rp, 32);  // refID pos lrn_mq_bin flag_nc l_seq nrid npos tlen
    int32_t ref_id = v[0], position = v[1];
    uint8_t l_read_name = (uint8_t)(v[2] & 0xff);
    uint8_t mq = (uint8_t)((v[2] >> 8) & 0xff);
    uint16_t n_cigar = (uint16_t)(v[3] & 0xffff);
    uint16_t fl = (uint16_t)((v[3] >> 16) & 0xffff);
    int32_t l_seq = v[4];
    rp += 32;

    tid.push_back(ref_id);
    pos.push_back(position);
    mapq.push_back(mq);
    flag.push_back(fl);
    mtid.push_back(v[5]);
    mpos.push_back(v[6]);
    tlen.push_back(v[7]);

    names.insert(names.end(), (const char*)buf + rp,
                 (const char*)buf + rp + l_read_name - 1);
    name_off.push_back((int64_t)names.size());
    rp += l_read_name;

    int32_t reflen = 0, flags = 0;
    int64_t querylen = 0;
    int prev_indel = 0, first_core = -1, last_core = -1;
    for (int k = 0; k < n_cigar; ++k) {
      uint32_t cv;
      std::memcpy(&cv, buf + rp + 4 * k, 4);
      cigars.push_back(cv);
      uint32_t op = cv & 0xF, n = cv >> 4;
      // M D N = X consume reference
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) reflen += n;
      // M I S = X consume query
      if (op == 0 || op == 1 || op == 4 || op == 7 || op == 8) querylen += n;
      if (op == 3) flags |= 1;                       // refskip
      int is_indel = (op == 1 || op == 2);
      if (is_indel && prev_indel) flags |= 2;        // consecutive indels
      prev_indel = is_indel;
      if (op != 4 && op != 5) {                      // non-clip core ops
        if (first_core < 0) first_core = (int)op;
        last_core = (int)op;
      }
    }
    if (first_core == 2 || last_core == 2) flags |= 4;  // edge deletion
    if (querylen != (int64_t)l_seq) flags |= 8;
    if (reflen == 0) flags |= 16;
    intrinsic.push_back(flags);
    cigar_off.push_back((int64_t)cigars.size());
    rlen.push_back(reflen);
    rp += 4 * (int64_t)n_cigar;

    int64_t nbytes = (l_seq + 1) / 2;
    for (int64_t k = 0; k < l_seq; ++k) {
      uint8_t packed = buf[rp + (k >> 1)];
      uint8_t code = (k & 1) ? (packed & 0xF) : (packed >> 4);
      seq.push_back((uint8_t)SEQ_NT[code]);
    }
    rp += nbytes;
    qual.insert(qual.end(), buf + rp, buf + rp + l_seq);
    seq_off.push_back((int64_t)seq.size());
    rp += l_seq;

    tags.insert(tags.end(), buf + rp, buf + rend);
    tag_off.push_back((int64_t)tags.size());
    p = rend;
  }
  if (p != len) return nullptr;

  BamColumns* c = (BamColumns*)std::calloc(1, sizeof(BamColumns));
  c->n = (int64_t)tid.size();
  auto dup_i32 = [](std::vector<int32_t>& v) {
    int32_t* p = (int32_t*)std::malloc(v.size() * 4 + 4);
    std::memcpy(p, v.data(), v.size() * 4);
    return p;
  };
  auto dup_i64 = [](std::vector<int64_t>& v) {
    int64_t* p = (int64_t*)std::malloc(v.size() * 8 + 8);
    std::memcpy(p, v.data(), v.size() * 8);
    return p;
  };
  c->tid = dup_i32(tid); c->pos = dup_i32(pos); c->mapq = dup_i32(mapq);
  c->flag = dup_i32(flag); c->mate_tid = dup_i32(mtid);
  c->mate_pos = dup_i32(mpos); c->tlen = dup_i32(tlen);
  c->ref_len = dup_i32(rlen);
  c->intrinsic = dup_i32(intrinsic);
  c->name_off = dup_i64(name_off); c->cigar_off = dup_i64(cigar_off);
  c->seq_off = dup_i64(seq_off); c->tag_off = dup_i64(tag_off);
  c->names = (char*)std::malloc(names.size() + 1);
  std::memcpy(c->names, names.data(), names.size());
  c->cigars = (uint32_t*)std::malloc(cigars.size() * 4 + 4);
  std::memcpy(c->cigars, cigars.data(), cigars.size() * 4);
  c->seq = (uint8_t*)std::malloc(seq.size() + 1);
  std::memcpy(c->seq, seq.data(), seq.size());
  c->qual = (uint8_t*)std::malloc(qual.size() + 1);
  std::memcpy(c->qual, qual.data(), qual.size());
  c->tags = (uint8_t*)std::malloc(tags.size() + 1);
  std::memcpy(c->tags, tags.data(), tags.size());
  return c;
}

void bam_columns_free(BamColumns* c) {
  if (!c) return;
  std::free(c->tid); std::free(c->pos); std::free(c->mapq); std::free(c->flag);
  std::free(c->mate_tid); std::free(c->mate_pos); std::free(c->tlen);
  std::free(c->ref_len); std::free(c->intrinsic);
  std::free(c->name_off); std::free(c->cigar_off);
  std::free(c->seq_off); std::free(c->tag_off); std::free(c->names);
  std::free(c->cigars); std::free(c->seq); std::free(c->qual); std::free(c->tags);
  std::free(c);
}

}  // extern "C"
