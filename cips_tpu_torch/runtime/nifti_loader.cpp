// The port's native data-loading runtime: NIfTI-1 decode + preprocess + a
// prefetch pool (cips_tpu_torch's own copy of cips_tpu/runtime/nifti_loader.cpp).
//
//   * NIfTI-1 parser (.nii and .nii.gz via zlib), dtype conversion,
//     scl_slope/inter application;
//   * fused symmetric-pad + center-crop + optional per-volume max-normalise
//     into a caller-provided float32 buffer (the (96,128,96) working shape),
//     equal bit for bit to the numpy path (data/nifti.py read_array, then
//     dataset.pad_crop_np and max_normalize_np);
//   * a pthread prefetch pool that decodes (t1, pet) pairs ahead of the
//     training loop into a bounded queue of ready samples. Samples come back
//     in the order their decodes finish; the caller restores its own order.
//
// Host code only. Exposed as a plain C API consumed via ctypes
// (cips_tpu_torch/runtime/native.py), which builds it with g++ at first use.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <limits>
#include <condition_variable>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr int kHeaderSize = 348;

struct NiftiHeader {
  int64_t dims[8];
  int datatype;
  float scl_slope;
  float scl_inter;
  int64_t vox_offset;
  bool byteswap;
};

uint16_t bswap16(uint16_t v) { return (uint16_t)((v >> 8) | (v << 8)); }
uint32_t bswap32(uint32_t v) {
  return ((v >> 24) & 0xff) | ((v >> 8) & 0xff00) | ((v << 8) & 0xff0000) | (v << 24);
}

float read_f32(const uint8_t* p, bool swap) {
  uint32_t u;
  std::memcpy(&u, p, 4);
  if (swap) u = bswap32(u);
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

int16_t read_i16(const uint8_t* p, bool swap) {
  uint16_t u;
  std::memcpy(&u, p, 2);
  if (swap) u = bswap16(u);
  int16_t v;
  std::memcpy(&v, &u, 2);
  return v;
}

// Read a whole file, inflating if gzip. Returns false on error.
bool read_all(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[2] = {0, 0};
  size_t got = std::fread(magic, 1, 2, f);
  std::fclose(f);
  if (got != 2) return false;

  if (magic[0] == 0x1f && magic[1] == 0x8b) {
    gzFile gz = gzopen(path, "rb");
    if (!gz) return false;
    gzbuffer(gz, 1 << 20);
    out->clear();
    out->reserve(1 << 22);
    uint8_t buf[1 << 20];
    int n;
    while ((n = gzread(gz, buf, sizeof(buf))) > 0) out->insert(out->end(), buf, buf + n);
    gzclose(gz);
    return n == 0;
  }
  f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize((size_t)size);
  bool ok = std::fread(out->data(), 1, (size_t)size, f) == (size_t)size;
  std::fclose(f);
  return ok;
}

bool parse_header(const std::vector<uint8_t>& raw, NiftiHeader* h) {
  if (raw.size() < (size_t)kHeaderSize + 4) return false;
  int32_t sizeof_hdr;
  std::memcpy(&sizeof_hdr, raw.data(), 4);
  h->byteswap = false;
  if (sizeof_hdr != kHeaderSize) {
    sizeof_hdr = (int32_t)bswap32((uint32_t)sizeof_hdr);
    if (sizeof_hdr != kHeaderSize) return false;
    h->byteswap = true;
  }
  const uint8_t* p = raw.data();
  int16_t ndim = read_i16(p + 40, h->byteswap);
  if (ndim < 1 || ndim > 7) return false;
  for (int i = 0; i < 8; ++i) h->dims[i] = 1;
  h->dims[0] = ndim;
  for (int i = 1; i <= ndim; ++i) {
    int16_t d = read_i16(p + 40 + 2 * i, h->byteswap);
    h->dims[i] = d > 0 ? d : 1;
  }
  h->datatype = read_i16(p + 70, h->byteswap);
  h->scl_slope = read_f32(p + 112, h->byteswap);
  h->scl_inter = read_f32(p + 116, h->byteswap);
  h->vox_offset = (int64_t)read_f32(p + 108, h->byteswap);
  if (h->vox_offset < kHeaderSize) h->vox_offset = kHeaderSize + 4;
  return true;
}

// Convert raw voxels to float32 (x-fastest / Fortran order preserved).
bool convert_voxels(const std::vector<uint8_t>& raw, const NiftiHeader& h,
                    std::vector<float>* out, int64_t count) {
  const uint8_t* src = raw.data() + h.vox_offset;
  int64_t avail = (int64_t)raw.size() - h.vox_offset;
  out->resize((size_t)count);
  float* dst = out->data();
  bool swap = h.byteswap;

  auto need = [&](int64_t bytes) { return avail >= bytes; };
  switch (h.datatype) {
    case 2: {  // uint8
      if (!need(count)) return false;
      for (int64_t i = 0; i < count; ++i) dst[i] = (float)src[i];
      break;
    }
    case 256: {  // int8
      if (!need(count)) return false;
      const int8_t* s = (const int8_t*)src;
      for (int64_t i = 0; i < count; ++i) dst[i] = (float)s[i];
      break;
    }
    case 4: {  // int16
      if (!need(count * 2)) return false;
      for (int64_t i = 0; i < count; ++i) dst[i] = (float)read_i16(src + 2 * i, swap);
      break;
    }
    case 512: {  // uint16
      if (!need(count * 2)) return false;
      for (int64_t i = 0; i < count; ++i) {
        uint16_t u;
        std::memcpy(&u, src + 2 * i, 2);
        if (swap) u = bswap16(u);
        dst[i] = (float)u;
      }
      break;
    }
    case 8: {  // int32
      if (!need(count * 4)) return false;
      for (int64_t i = 0; i < count; ++i) {
        uint32_t u;
        std::memcpy(&u, src + 4 * i, 4);
        if (swap) u = bswap32(u);
        int32_t v;
        std::memcpy(&v, &u, 4);
        dst[i] = (float)v;
      }
      break;
    }
    case 16: {  // float32
      if (!need(count * 4)) return false;
      for (int64_t i = 0; i < count; ++i) dst[i] = read_f32(src + 4 * i, swap);
      break;
    }
    case 64: {  // float64
      if (!need(count * 8)) return false;
      for (int64_t i = 0; i < count; ++i) {
        uint64_t u;
        std::memcpy(&u, src + 8 * i, 8);
        if (swap) {
          u = ((uint64_t)bswap32((uint32_t)u) << 32) | bswap32((uint32_t)(u >> 32));
        }
        double d;
        std::memcpy(&d, &u, 8);
        dst[i] = (float)d;
      }
      break;
    }
    default:
      return false;
  }
  // as the numpy reader (data/nifti.py): a slope of 0 reads as 1, and the
  // product and the sum round to float32 one after the other
  if ((h.scl_slope != 0.0f && h.scl_slope != 1.0f) || h.scl_inter != 0.0f) {
    const float slope = h.scl_slope != 0.0f ? h.scl_slope : 1.0f;
    for (int64_t i = 0; i < count; ++i) dst[i] = dst[i] * slope + h.scl_inter;
  }
  return true;
}

// Fused symmetric-pad + center-crop (MONAI SpatialPad + CenterSpatialCrop
// semantics, dataset.py:81-83) + optional max-normalise, into (tz, ty, tx)
// z-major output. Source volume is (nz, ny, nx) z-major (== reversed nifti
// dims, the sitk array convention). The normalisation is the numpy path's
// (dataset.max_normalize_np) bit for bit: each voxel divided by the maximum of
// the padded and cropped volume, or by 1e-12 where that maximum is smaller.
void pad_crop_normalize(const float* src, int64_t nz, int64_t ny, int64_t nx,
                        float* dst, int64_t tz, int64_t ty, int64_t tx,
                        bool normalize) {
  auto span = [](int64_t n, int64_t t, int64_t* src0, int64_t* dst0, int64_t* len) {
    if (n >= t) {  // crop: drop (n-t)/2 from the front
      *src0 = (n - t) / 2;
      *dst0 = 0;
      *len = t;
    } else {  // pad: (t-n)/2 zeros in front
      *src0 = 0;
      *dst0 = (t - n) / 2;
      *len = n;
    }
  };
  int64_t sz0, dz0, lz, sy0, dy0, ly, sx0, dx0, lx;
  span(nz, tz, &sz0, &dz0, &lz);
  span(ny, ty, &sy0, &dy0, &ly);
  span(nx, tx, &sx0, &dx0, &lx);

  std::memset(dst, 0, sizeof(float) * (size_t)(tz * ty * tx));
  // the padding's zeros count towards the maximum
  float maxv = (lz < tz || ly < ty || lx < tx) ? 0.0f : -std::numeric_limits<float>::infinity();
  for (int64_t z = 0; z < lz; ++z) {
    for (int64_t y = 0; y < ly; ++y) {
      const float* s = src + ((sz0 + z) * ny + (sy0 + y)) * nx + sx0;
      float* d = dst + ((dz0 + z) * ty + (dy0 + y)) * tx + dx0;
      std::memcpy(d, s, sizeof(float) * (size_t)lx);
      if (normalize) {
        for (int64_t x = 0; x < lx; ++x)
          if (d[x] > maxv) maxv = d[x];
      }
    }
  }
  if (normalize) {
    const float divisor = (double)maxv > 1e-12 ? maxv : 1e-12f;
    for (int64_t i = 0; i < tz * ty * tx; ++i) dst[i] /= divisor;
  }
}

bool decode_to(const char* path, float* out, int64_t tz, int64_t ty, int64_t tx,
               bool normalize) {
  std::vector<uint8_t> raw;
  if (!read_all(path, &raw)) return false;
  NiftiHeader h;
  if (!parse_header(raw, &h)) return false;
  // nifti dims are x, y, z (x fastest); our arrays are z-major
  int64_t nx = h.dims[1], ny = h.dims[2], nz = h.dims[3];
  int64_t count = nx * ny * nz;
  std::vector<float> vox;
  if (!convert_voxels(raw, h, &vox, count)) return false;
  pad_crop_normalize(vox.data(), nz, ny, nx, out, tz, ty, tx, normalize);
  return true;
}

// ---------------------------------------------------------------------------
// prefetch pool: decodes (t1, pet) path pairs ahead of the training loop
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> t1_paths;
  std::vector<std::string> pet_paths;
  int64_t tz, ty, tx;
  bool normalize;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::queue<int64_t> pending;                      // sample indices to decode
  std::queue<std::pair<int64_t, float*>> ready;     // decoded (index, buffer)
  int64_t in_flight = 0;  // popped from pending, not yet pushed to ready (mu)
  size_t capacity;
  std::atomic<bool> stop{false};
  std::atomic<int64_t> errors{0};

  int64_t vol_elems() const { return tz * ty * tx; }

  void worker() {
    const int64_t n = vol_elems();
    while (true) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stop.load() || (!pending.empty() && ready.size() < capacity); });
        if (stop.load()) return;
        idx = pending.front();
        pending.pop();
        ++in_flight;  // keep the sample visible to next()'s drain predicate
      }
      float* buf = (float*)std::malloc(sizeof(float) * (size_t)(2 * n));
      bool ok = buf != nullptr;
      if (ok) ok = decode_to(t1_paths[(size_t)idx].c_str(), buf, tz, ty, tx, normalize);
      if (ok) ok = decode_to(pet_paths[(size_t)idx].c_str(), buf + n, tz, ty, tx, normalize);
      if (!ok) {
        errors.fetch_add(1);
        if (buf) std::free(buf);
        buf = nullptr;  // nullptr buffer == decode failure for this sample
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        --in_flight;
        ready.emplace(idx, buf);
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Decode one NIfTI into a float32 (tz, ty, tx) buffer with fused
// pad/crop/max-normalise. Returns 0 on success.
int cips_nifti_decode(const char* path, float* out, int64_t tz, int64_t ty,
                      int64_t tx, int normalize) {
  return decode_to(path, out, tz, ty, tx, normalize != 0) ? 0 : 1;
}

// Query a NIfTI's (z, y, x) dims without decoding voxels. Returns 0 on success.
int cips_nifti_shape(const char* path, int64_t* zyx) {
  std::vector<uint8_t> raw;
  if (!read_all(path, &raw)) return 1;
  NiftiHeader h;
  if (!parse_header(raw, &h)) return 1;
  zyx[0] = h.dims[3];
  zyx[1] = h.dims[2];
  zyx[2] = h.dims[1];
  return 0;
}

void* cips_prefetcher_create(const char** t1_paths, const char** pet_paths,
                             int64_t n, int64_t tz, int64_t ty, int64_t tx,
                             int normalize, int n_threads, int64_t capacity) {
  auto* p = new Prefetcher();
  p->t1_paths.assign(t1_paths, t1_paths + n);
  p->pet_paths.assign(pet_paths, pet_paths + n);
  p->tz = tz; p->ty = ty; p->tx = tx;
  p->normalize = normalize != 0;
  p->capacity = (size_t)capacity;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i) p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Enqueue sample indices (one shuffled epoch).
void cips_prefetcher_submit(void* handle, const int64_t* indices, int64_t n) {
  auto* p = (Prefetcher*)handle;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    for (int64_t i = 0; i < n; ++i) p->pending.push(indices[i]);
  }
  p->cv_space.notify_all();
}

// Pop one decoded sample; copies (2, tz, ty, tx) floats into dst.
// Returns the sample index; -1 once pending, in-flight AND ready are all
// empty (drained); or -2 - index when that sample's decode failed (dst is
// untouched — the caller must skip it).
int64_t cips_prefetcher_next(void* handle, float* dst) {
  auto* p = (Prefetcher*)handle;
  std::pair<int64_t, float*> item;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    // A worker pops `pending` before decoding outside the lock; `in_flight`
    // keeps those samples visible so the tail of an epoch is never dropped.
    p->cv_ready.wait(lk, [&] {
      return !p->ready.empty() || (p->pending.empty() && p->in_flight == 0);
    });
    if (p->ready.empty()) return -1;
    item = p->ready.front();
    p->ready.pop();
  }
  p->cv_space.notify_all();
  if (item.second == nullptr) return -2 - item.first;  // decode failed
  std::memcpy(dst, item.second, sizeof(float) * (size_t)(2 * p->vol_elems()));
  std::free(item.second);
  return item.first;
}

int64_t cips_prefetcher_errors(void* handle) {
  return ((Prefetcher*)handle)->errors.load();
}

void cips_prefetcher_destroy(void* handle) {
  auto* p = (Prefetcher*)handle;
  {
    // under the mutex: a worker between its predicate check and its wait
    // would otherwise miss the notification and never join
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
  }
  p->cv_space.notify_all();
  for (auto& t : p->workers) t.join();
  while (!p->ready.empty()) {
    std::free(p->ready.front().second);
    p->ready.pop();
  }
  delete p;
}

}  // extern "C"
