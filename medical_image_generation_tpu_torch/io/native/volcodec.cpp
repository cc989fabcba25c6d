// volcodec: native chunked-compressed volume codec of the PyTorch port.
//
// The port's own copy of medical_image_generation_tpu/io/native/volcodec.cpp
// (same C API, same byte shuffle, same chunk order), so that each package
// reads the other's VolStore files. It replaces the reference's zarr +
// Blosc(zstd, clevel=5, BITSHUFFLE) preprocessed-volume store (reference
// configuration.py:1404-1412) and its lazy bbox reads in the patch sampler
// (data_processing.py:148-225).
//
// Design:
//   * N-d array split into regular chunks (like zarr), each chunk compressed
//     independently with zstd after a byte-shuffle filter (Blosc-SHUFFLE
//     equivalent: transposes bytes of fixed-size elements so same-significance
//     bytes are adjacent, which compresses float data far better).
//   * The Python side (io/volstore.py) owns the file format / metadata; this
//     library only sees raw buffers + chunk tables, so it stays format-agnostic.
//   * Hot path for training: vsc_read_bbox() pread()s + decompresses only the
//     chunks overlapping a bounding box and scatters them into the output
//     buffer with zero-fill for out-of-bounds regions -- the crop_and_pad_nd
//     semantics of the reference data loader, done in native code with a
//     thread pool.
//
// Two differences from the JAX package's source. It declares the four zstd
// functions it calls itself and links the runtime library libzstd.so.1, so
// it builds without zstd.h. And there,
// gather_chunk_from_array adds the innermost chunk origin twice, so a chunk
// shape that splits the last axis is written with the wrong voxels (the
// default (1, 1, Y, X) chunks never split it). Here it is added once.
//
// C API only (used via ctypes). No Python.h dependency. A host codec, built
// with g++, not a device kernel.

#include <cstddef>

// The zstd functions this file calls, as zstd's stable API has declared
// them since 1.0.
extern "C" {
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src, size_t srcSize,
                     int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src, size_t compressedSize);
unsigned ZSTD_isError(size_t code);
}

#include <algorithm>
#include <atomic>
#include <functional>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#ifdef _WIN32
#error "POSIX only"
#endif
#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr int kMaxDims = 8;

// ----------------------------------------------------------------------------
// byte shuffle filter (Blosc SHUFFLE equivalent)
// ----------------------------------------------------------------------------

void shuffle_bytes(const uint8_t* src, uint8_t* dst, size_t nbytes, size_t itemsize) {
  if (itemsize <= 1) {
    std::memcpy(dst, src, nbytes);
    return;
  }
  const size_t nitems = nbytes / itemsize;
  const size_t tail = nbytes - nitems * itemsize;
  for (size_t b = 0; b < itemsize; ++b) {
    const uint8_t* s = src + b;
    uint8_t* d = dst + b * nitems;
    for (size_t i = 0; i < nitems; ++i) d[i] = s[i * itemsize];
  }
  if (tail) std::memcpy(dst + nitems * itemsize, src + nitems * itemsize, tail);
}

void unshuffle_bytes(const uint8_t* src, uint8_t* dst, size_t nbytes, size_t itemsize) {
  if (itemsize <= 1) {
    std::memcpy(dst, src, nbytes);
    return;
  }
  const size_t nitems = nbytes / itemsize;
  const size_t tail = nbytes - nitems * itemsize;
  for (size_t b = 0; b < itemsize; ++b) {
    const uint8_t* s = src + b * nitems;
    uint8_t* d = dst + b;
    for (size_t i = 0; i < nitems; ++i) d[i * itemsize] = s[i];
  }
  if (tail) std::memcpy(dst + nitems * itemsize, src + nitems * itemsize, tail);
}

// ----------------------------------------------------------------------------
// small helpers
// ----------------------------------------------------------------------------

struct Shape {
  int ndim;
  int64_t dim[kMaxDims];
};

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Iterate over all chunk grid coordinates; returns total chunk count.
int64_t num_chunks(const Shape& shape, const Shape& chunk) {
  int64_t n = 1;
  for (int d = 0; d < shape.ndim; ++d) n *= cdiv(shape.dim[d], chunk.dim[d]);
  return n;
}

void chunk_grid(const Shape& shape, const Shape& chunk, Shape* grid) {
  grid->ndim = shape.ndim;
  for (int d = 0; d < shape.ndim; ++d) grid->dim[d] = cdiv(shape.dim[d], chunk.dim[d]);
}

// Copy the intersection of a decompressed chunk with [lbs, ubs) into out.
// out has shape (ubs - lbs); regions outside the array stay zero.
void scatter_chunk_into_bbox(const uint8_t* chunk_data, const int64_t* chunk_origin,
                             const int64_t* chunk_shape_full, const int64_t* chunk_shape_actual,
                             const int64_t* lbs, const int64_t* ubs, uint8_t* out, int ndim,
                             size_t itemsize) {
  // Intersection of [chunk_origin, chunk_origin + actual) with [lbs, ubs)
  int64_t lo[kMaxDims], hi[kMaxDims];
  for (int d = 0; d < ndim; ++d) {
    lo[d] = std::max(chunk_origin[d], lbs[d]);
    hi[d] = std::min(chunk_origin[d] + chunk_shape_actual[d], ubs[d]);
    if (lo[d] >= hi[d]) return;  // empty
  }
  // strides (in elements) of the chunk buffer and of the output buffer
  int64_t cs[kMaxDims], os[kMaxDims], out_shape[kMaxDims];
  int64_t c_stride = 1, o_stride = 1;
  for (int d = ndim - 1; d >= 0; --d) {
    cs[d] = c_stride;
    c_stride *= chunk_shape_full[d];
    out_shape[d] = ubs[d] - lbs[d];
    os[d] = o_stride;
    o_stride *= out_shape[d];
  }
  // innermost dim copied as contiguous runs
  const int inner = ndim - 1;
  const int64_t run = (hi[inner] - lo[inner]) * (int64_t)itemsize;
  // iterate over the outer dims of the intersection
  int64_t idx[kMaxDims];
  for (int d = 0; d < ndim; ++d) idx[d] = lo[d];
  while (true) {
    int64_t coff = 0, ooff = 0;
    for (int d = 0; d < ndim; ++d) {
      const int64_t v = (d == inner) ? lo[d] : idx[d];
      coff += (v - chunk_origin[d]) * cs[d];
      ooff += (v - lbs[d]) * os[d];
    }
    std::memcpy(out + ooff * itemsize, chunk_data + coff * itemsize, run);
    // advance outer dims (excluding inner)
    int d = inner - 1;
    for (; d >= 0; --d) {
      if (++idx[d] < hi[d]) break;
      idx[d] = lo[d];
    }
    if (d < 0) break;
  }
}

// Gather a chunk's worth of data out of a full array (with edge chunks
// zero-padded to full chunk shape for uniform compression blocks).
void gather_chunk_from_array(const uint8_t* array, const int64_t* array_shape,
                             const int64_t* chunk_origin, const int64_t* chunk_shape_full,
                             uint8_t* chunk_buf, int ndim, size_t itemsize) {
  int64_t actual[kMaxDims];
  for (int d = 0; d < ndim; ++d)
    actual[d] = std::min(chunk_shape_full[d], array_shape[d] - chunk_origin[d]);

  int64_t as[kMaxDims], cs[kMaxDims];
  int64_t a_stride = 1, c_stride = 1;
  for (int d = ndim - 1; d >= 0; --d) {
    as[d] = a_stride;
    a_stride *= array_shape[d];
    cs[d] = c_stride;
    c_stride *= chunk_shape_full[d];
  }
  const int inner = ndim - 1;
  const int64_t run = actual[inner] * (int64_t)itemsize;
  const bool partial = [&] {
    for (int d = 0; d < ndim; ++d)
      if (actual[d] != chunk_shape_full[d]) return true;
    return false;
  }();
  if (partial) {
    int64_t total = 1;
    for (int d = 0; d < ndim; ++d) total *= chunk_shape_full[d];
    std::memset(chunk_buf, 0, total * itemsize);
  }

  int64_t idx[kMaxDims] = {0};
  while (true) {
    int64_t aoff = 0, coff = 0;
    for (int d = 0; d < ndim; ++d) {
      const int64_t v = (d == inner) ? 0 : idx[d];
      aoff += (chunk_origin[d] + v) * as[d];  // the inner dim's origin included
      coff += v * cs[d];
    }
    std::memcpy(chunk_buf + coff * itemsize, array + aoff * itemsize, run);
    int d = inner - 1;
    for (; d >= 0; --d) {
      if (++idx[d] < actual[d]) break;
      idx[d] = 0;
    }
    if (d < 0) break;
  }
}

void parallel_for(int64_t n, int max_threads, const std::function<void(int64_t)>& fn) {
  int nthreads = (int)std::min<int64_t>(n, std::max(1, max_threads));
  if (nthreads <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> workers;
  workers.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    workers.emplace_back([&] {
      while (true) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Opaque handle for a compression result: per-chunk compressed blobs.
struct VscCompressed {
  std::vector<std::vector<uint8_t>> chunks;
};

// Compress `array` (C-contiguous, shape[ndim], itemsize bytes/elem) into
// per-chunk zstd blobs with byte-shuffle. Returns handle (free with
// vsc_free). On error returns nullptr.
VscCompressed* vsc_compress(const uint8_t* array, int ndim, const int64_t* shape,
                            const int64_t* chunk_shape, int64_t itemsize, int level,
                            int shuffle, int nthreads) {
  if (ndim <= 0 || ndim > kMaxDims) return nullptr;
  Shape sh, ch, grid;
  sh.ndim = ch.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    sh.dim[d] = shape[d];
    ch.dim[d] = chunk_shape[d];
    if (shape[d] <= 0 || chunk_shape[d] <= 0) return nullptr;
  }
  chunk_grid(sh, ch, &grid);
  const int64_t n = num_chunks(sh, ch);
  int64_t chunk_elems = 1;
  for (int d = 0; d < ndim; ++d) chunk_elems *= ch.dim[d];
  const size_t chunk_bytes = (size_t)chunk_elems * itemsize;

  auto* result = new VscCompressed();
  result->chunks.resize(n);
  std::atomic<bool> ok(true);

  parallel_for(n, nthreads, [&](int64_t ci) {
    if (!ok.load()) return;
    // chunk grid coordinate -> origin
    int64_t origin[kMaxDims];
    int64_t rem = ci;
    for (int d = ndim - 1; d >= 0; --d) {
      origin[d] = (rem % grid.dim[d]) * ch.dim[d];
      rem /= grid.dim[d];
    }
    std::vector<uint8_t> raw(chunk_bytes), shuf(chunk_bytes);
    gather_chunk_from_array(array, sh.dim, origin, ch.dim, raw.data(), ndim, itemsize);
    const uint8_t* to_compress = raw.data();
    if (shuffle) {
      shuffle_bytes(raw.data(), shuf.data(), chunk_bytes, itemsize);
      to_compress = shuf.data();
    }
    const size_t bound = ZSTD_compressBound(chunk_bytes);
    std::vector<uint8_t> out(bound);
    const size_t csize = ZSTD_compress(out.data(), bound, to_compress, chunk_bytes, level);
    if (ZSTD_isError(csize)) {
      ok.store(false);
      return;
    }
    out.resize(csize);
    result->chunks[ci] = std::move(out);
  });

  if (!ok.load()) {
    delete result;
    return nullptr;
  }
  return result;
}

int64_t vsc_num_chunks(const VscCompressed* h) { return (int64_t)h->chunks.size(); }

int64_t vsc_chunk_size(const VscCompressed* h, int64_t i) {
  return (int64_t)h->chunks[(size_t)i].size();
}

void vsc_copy_chunk(const VscCompressed* h, int64_t i, uint8_t* dst) {
  const auto& c = h->chunks[(size_t)i];
  std::memcpy(dst, c.data(), c.size());
}

void vsc_free(VscCompressed* h) { delete h; }

// Read a bounding box [lbs, ubs) (may extend outside the array; out-of-bounds
// is zero-filled) from a chunked-compressed file. `offsets`/`csizes` give each
// chunk's byte position in the file, in row-major chunk-grid order.
// `out` must hold prod(ubs - lbs) * itemsize bytes. Returns 0 on success.
int vsc_read_bbox(const char* path, int64_t data_offset, const int64_t* offsets,
                  const int64_t* csizes, int ndim, const int64_t* shape,
                  const int64_t* chunk_shape, int64_t itemsize, int shuffle,
                  const int64_t* lbs, const int64_t* ubs, uint8_t* out, int nthreads) {
  if (ndim <= 0 || ndim > kMaxDims) return -1;
  Shape sh, ch, grid;
  sh.ndim = ch.ndim = ndim;
  int64_t out_elems = 1;
  for (int d = 0; d < ndim; ++d) {
    sh.dim[d] = shape[d];
    ch.dim[d] = chunk_shape[d];
    if (ubs[d] <= lbs[d]) return -2;
    out_elems *= (ubs[d] - lbs[d]);
  }
  chunk_grid(sh, ch, &grid);
  std::memset(out, 0, (size_t)out_elems * itemsize);

  // chunk-grid range overlapping the clipped bbox
  int64_t glo[kMaxDims], ghi[kMaxDims];
  for (int d = 0; d < ndim; ++d) {
    const int64_t clo = std::max<int64_t>(lbs[d], 0);
    const int64_t chi = std::min<int64_t>(ubs[d], sh.dim[d]);
    if (clo >= chi) return 0;  // bbox entirely outside: all zeros
    glo[d] = clo / ch.dim[d];
    ghi[d] = (chi - 1) / ch.dim[d] + 1;
  }
  // enumerate overlapping chunks
  std::vector<int64_t> chunk_ids;
  int64_t idx[kMaxDims];
  for (int d = 0; d < ndim; ++d) idx[d] = glo[d];
  while (true) {
    int64_t ci = 0;
    for (int d = 0; d < ndim; ++d) ci = ci * grid.dim[d] + idx[d];
    chunk_ids.push_back(ci);
    int d = ndim - 1;
    for (; d >= 0; --d) {
      if (++idx[d] < ghi[d]) break;
      idx[d] = glo[d];
    }
    if (d < 0) break;
  }

  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -3;

  int64_t chunk_elems = 1;
  for (int d = 0; d < ndim; ++d) chunk_elems *= ch.dim[d];
  const size_t chunk_bytes = (size_t)chunk_elems * itemsize;

  std::atomic<int> status(0);
  parallel_for((int64_t)chunk_ids.size(), nthreads, [&](int64_t k) {
    if (status.load() != 0) return;
    const int64_t ci = chunk_ids[(size_t)k];
    const int64_t off = data_offset + offsets[ci];
    const int64_t csize = csizes[ci];
    std::vector<uint8_t> cbuf((size_t)csize);
    ssize_t got = ::pread(fd, cbuf.data(), (size_t)csize, (off_t)off);
    if (got != (ssize_t)csize) {
      status.store(-4);
      return;
    }
    std::vector<uint8_t> dbuf(chunk_bytes), ubuf;
    const size_t dsize = ZSTD_decompress(dbuf.data(), chunk_bytes, cbuf.data(), (size_t)csize);
    if (ZSTD_isError(dsize) || dsize != chunk_bytes) {
      status.store(-5);
      return;
    }
    const uint8_t* chunk_data = dbuf.data();
    if (shuffle) {
      ubuf.resize(chunk_bytes);
      unshuffle_bytes(dbuf.data(), ubuf.data(), chunk_bytes, itemsize);
      chunk_data = ubuf.data();
    }
    // chunk origin + actual extent
    int64_t origin[kMaxDims], actual[kMaxDims], rem = ci;
    for (int d = ndim - 1; d >= 0; --d) {
      origin[d] = (rem % grid.dim[d]) * ch.dim[d];
      rem /= grid.dim[d];
    }
    for (int d = 0; d < ndim; ++d)
      actual[d] = std::min(ch.dim[d], sh.dim[d] - origin[d]);
    scatter_chunk_into_bbox(chunk_data, origin, ch.dim, actual, lbs, ubs, out, ndim, itemsize);
  });

  ::close(fd);
  return status.load();
}

}  // extern "C"
