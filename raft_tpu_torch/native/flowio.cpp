// Native flow-file codec of raft_tpu_torch: the port's own copy of
// raft_tpu/native/flowio.cpp: the same functions with the same semantics
// (its PFM reader reads the payload in one call).
//
// Role: the loaders' threads read .flo and .pfm files here, outside the GIL:
// the Middlebury .flo codec (frame_utils.py:10-31,70-99 semantics) and the
// PFM decode (frame_utils.py:33-68). The numpy readers in
// raft_tpu_torch/data/frame_utils.py do the same where no g++ is found.
//
// Built with plain g++ into build/native/ at first use; bound via ctypes.
// Every entry point returns 0 on success or a negative error code, so the
// Python wrapper can fall back to the numpy implementations.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kFloTag = 202021.25f;

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrShort = -3;

struct FileCloser {
  FILE* f;
  ~FileCloser() {
    if (f) fclose(f);
  }
};

}  // namespace

extern "C" {

// Reads the (w, h) header of a .flo file. Returns kOk and fills dims.
int flo_header(const char* path, int32_t* w, int32_t* h) {
  FILE* f = fopen(path, "rb");
  FileCloser closer{f};
  if (!f) return kErrOpen;
  float tag;
  if (fread(&tag, 4, 1, f) != 1 || tag != kFloTag) return kErrFormat;
  if (fread(w, 4, 1, f) != 1 || fread(h, 4, 1, f) != 1) return kErrShort;
  if (*w <= 0 || *h <= 0 || *w > 1 << 16 || *h > 1 << 16) return kErrFormat;
  return kOk;
}

// Reads .flo payload into out (h*w*2 floats, caller-allocated).
int flo_read(const char* path, float* out, int32_t w, int32_t h) {
  FILE* f = fopen(path, "rb");
  FileCloser closer{f};
  if (!f) return kErrOpen;
  if (fseek(f, 12, SEEK_SET) != 0) return kErrShort;
  size_t n = static_cast<size_t>(w) * h * 2;
  if (fread(out, 4, n, f) != n) return kErrShort;
  return kOk;
}

int flo_write(const char* path, const float* uv, int32_t w, int32_t h) {
  FILE* f = fopen(path, "wb");
  FileCloser closer{f};
  if (!f) return kErrOpen;
  if (fwrite(&kFloTag, 4, 1, f) != 1) return kErrShort;
  if (fwrite(&w, 4, 1, f) != 1 || fwrite(&h, 4, 1, f) != 1) return kErrShort;
  size_t n = static_cast<size_t>(w) * h * 2;
  if (fwrite(uv, 4, n, f) != n) return kErrShort;
  return kOk;
}

// Parses a PFM header; returns byte offset of the payload, fills dims,
// channels (1 or 3) and little_endian flag.
int pfm_header(const char* path, int32_t* w, int32_t* h, int32_t* channels,
               int32_t* little_endian, int64_t* payload_offset) {
  FILE* f = fopen(path, "rb");
  FileCloser closer{f};
  if (!f) return kErrOpen;
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1) return kErrFormat;
  if (strcmp(magic, "PF") == 0) {
    *channels = 3;
  } else if (strcmp(magic, "Pf") == 0) {
    *channels = 1;
  } else {
    return kErrFormat;
  }
  float scale;
  if (fscanf(f, "%d %d %f", w, h, &scale) != 3) return kErrFormat;
  // the header ends at the first newline after the scale; tolerate CRLF
  // (a lone fgetc would leave the '\n' in the stream and shift the
  // payload by one byte — silently corrupt floats)
  int ch;
  do {
    ch = fgetc(f);
    if (ch == EOF) return kErrShort;
  } while (ch != '\n');
  if (*w <= 0 || *h <= 0) return kErrFormat;
  *little_endian = scale < 0 ? 1 : 0;
  *payload_offset = ftell(f);
  return kOk;
}

// Reads PFM payload into out (h*w*channels floats), rows flipped top-down
// and endianness swapped if needed.
int pfm_read(const char* path, float* out, int32_t w, int32_t h,
             int32_t channels, int32_t little_endian,
             int64_t payload_offset) {
  FILE* f = fopen(path, "rb");
  FileCloser closer{f};
  if (!f) return kErrOpen;
  if (fseek(f, static_cast<long>(payload_offset), SEEK_SET) != 0)
    return kErrShort;
  // the whole payload in one read (a read a row costs a system call a
  // row), then the rows flipped in place (PFM stores them bottom-up) and
  // byte-swapped if big-endian
  size_t row = static_cast<size_t>(w) * channels;
  size_t n = row * static_cast<size_t>(h);
  if (fread(out, 4, n, f) != n) return kErrShort;
  std::vector<float> tmp(row);
  for (int32_t y = 0; y < h / 2; ++y) {
    float* top = out + static_cast<size_t>(y) * row;
    float* bottom = out + static_cast<size_t>(h - 1 - y) * row;
    memcpy(tmp.data(), top, row * 4);
    memcpy(top, bottom, row * 4);
    memcpy(bottom, tmp.data(), row * 4);
  }
  if (!little_endian) {
    for (size_t i = 0; i < n; ++i) {
      uint32_t v;
      memcpy(&v, &out[i], 4);
      v = __builtin_bswap32(v);
      memcpy(&out[i], &v, 4);
    }
  }
  return kOk;
}

}  // extern "C"
