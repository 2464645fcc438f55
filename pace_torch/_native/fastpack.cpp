// fastpack: threaded .npy writer and reader for pace_torch.
//
// The port's own copy of the reference package's native writer
// (pace_tpu/_native/fastpack.cpp): restarts are written as one standard
// .npy file per field, several files at a time on native threads, without
// holding Python's interpreter lock.  Built with g++ at first use by
// pace_torch/_native/fastpack.py.
//
// C interface (used from Python via ctypes):
//   fastpack_write_npy(path, dtype_code, ndim, shape, data)  -> 0 on success
//   fastpack_write_many(n, paths[], dtype_codes[], ndims[], shapes[],
//                       datas[], n_threads)                  -> 0 on success
//   fastpack_read_npy_info(path, &dtype_code, &ndim, shape_out) -> bytes or -1
//   fastpack_read_npy_data(path, buffer, capacity)           -> bytes or -1
//
// dtype codes: 0=float32, 1=float64, 2=int32, 3=int64.
// The .npy format (v1.0) is written directly; files interoperate with
// numpy.load / numpy.save.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

const char* dtype_descr(int code) {
  switch (code) {
    case 0: return "<f4";
    case 1: return "<f8";
    case 2: return "<i4";
    case 3: return "<i8";
    default: return nullptr;
  }
}

size_t dtype_size(int code) {
  switch (code) {
    case 0: return 4;
    case 1: return 8;
    case 2: return 4;
    case 3: return 8;
    default: return 0;
  }
}

int write_one(const char* path, int dtype_code, int ndim,
              const int64_t* shape, const void* data) {
  const char* descr = dtype_descr(dtype_code);
  if (descr == nullptr || ndim < 0 || ndim > 8) return -1;

  std::string header = "{'descr': '";
  header += descr;
  header += "', 'fortran_order': False, 'shape': (";
  size_t count = 1;
  for (int i = 0; i < ndim; ++i) {
    char buf[32];
    std::snprintf(buf, sizeof(buf), "%lld", (long long)shape[i]);
    header += buf;
    if (ndim == 1 || i + 1 < ndim) header += ",";
    if (i + 1 < ndim) header += " ";
    count *= (size_t)shape[i];
  }
  header += "), }";
  // pad with spaces so that magic(6)+ver(2)+len(2)+header is 64-aligned,
  // terminated by '\n' (npy v1.0 spec)
  size_t unpadded = 10 + header.size() + 1;
  size_t padded = (unpadded + 63) / 64 * 64;
  header.append(padded - unpadded, ' ');
  header += '\n';

  std::FILE* f = std::fopen(path, "wb");
  if (f == nullptr) return -2;
  const unsigned char magic[8] = {0x93, 'N', 'U', 'M', 'P', 'Y', 1, 0};
  uint16_t hlen = (uint16_t)header.size();
  int ok = 1;
  ok &= std::fwrite(magic, 1, 8, f) == 8;
  ok &= std::fwrite(&hlen, 2, 1, f) == 1;
  ok &= std::fwrite(header.data(), 1, header.size(), f) == header.size();
  size_t nbytes = count * dtype_size(dtype_code);
  ok &= std::fwrite(data, 1, nbytes, f) == nbytes;
  std::fclose(f);
  return ok ? 0 : -3;
}

}  // namespace

extern "C" {

int fastpack_write_npy(const char* path, int dtype_code, int ndim,
                       const int64_t* shape, const void* data) {
  return write_one(path, dtype_code, ndim, shape, data);
}

int fastpack_write_many(int n, const char** paths, const int* dtype_codes,
                        const int* ndims, const int64_t** shapes,
                        const void** datas, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<int> results(n, 0);
  std::vector<std::thread> workers;
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int i = t; i < n; i += n_threads) {
        results[i] = write_one(paths[i], dtype_codes[i], ndims[i],
                               shapes[i], datas[i]);
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int i = 0; i < n; ++i) {
    if (results[i] != 0) return results[i];
  }
  return 0;
}

long long fastpack_read_npy_info(const char* path, int* dtype_code,
                                 int* ndim, int64_t* shape_out) {
  std::FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || magic[0] != 0x93 ||
      std::memcmp(magic + 1, "NUMPY", 5) != 0) {
    std::fclose(f);
    return -1;
  }
  uint16_t hlen = 0;
  if (std::fread(&hlen, 2, 1, f) != 1) { std::fclose(f); return -1; }
  std::string header(hlen, '\0');
  if (std::fread(&header[0], 1, hlen, f) != hlen) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);
  // parse descr
  *dtype_code = -1;
  for (int c = 0; c < 4; ++c) {
    if (header.find(std::string("'") + dtype_descr(c) + "'") !=
        std::string::npos) {
      *dtype_code = c;
    }
  }
  if (*dtype_code < 0) return -1;
  size_t p = header.find("'shape': (");
  if (p == std::string::npos) return -1;
  p += 10;
  int nd = 0;
  long long total = 1;
  while (p < header.size() && header[p] != ')') {
    while (p < header.size() && (header[p] == ' ' || header[p] == ','))
      ++p;
    if (p >= header.size() || header[p] == ')') break;
    long long v = 0;
    while (p < header.size() && header[p] >= '0' && header[p] <= '9') {
      v = v * 10 + (header[p] - '0');
      ++p;
    }
    if (nd < 8) shape_out[nd] = v;
    ++nd;
    total *= v;
  }
  *ndim = nd;
  return total * (long long)dtype_size(*dtype_code);
}

long long fastpack_read_npy_data(const char* path, void* buffer,
                                 long long capacity) {
  std::FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8) { std::fclose(f); return -1; }
  uint16_t hlen = 0;
  if (std::fread(&hlen, 2, 1, f) != 1) { std::fclose(f); return -1; }
  if (std::fseek(f, 10 + hlen, SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  long long got = (long long)std::fread(buffer, 1, (size_t)capacity, f);
  std::fclose(f);
  return got;
}

}  // extern "C"
