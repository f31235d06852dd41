// xbit_verify — standalone fixture-verification CLI.
//
// Role of the reference's bench entry (main.cc:11-105): load a fixture directory of
// raw binary tensors, run the scalar oracle, and diff against the golden output.
// Fixture layout (written by xbitops/utils/fixtures.py — all little-endian):
//   shape.txt   text: K N bits group_size add_zero_bias M
//   input.bin   fp16 bits,  M*K
//   qweight.bin int32, ceil(K*bits/32)*N
//   scales.bin  fp16 bits,  ceil(K/g)*N
//   qzeros.bin  int32, ceil(K/g)*ceil(N*bits/32)
//   weight.bin  fp16 bits,  K*N       (golden dequantized weights)
//   out.bin     fp16 bits,  M*N       (golden gemv output)
// Exit code 0 iff both dequant and gemv match within tolerance (abs 1e-3 for
// dequant, the reference's own DQ tolerance, unpack_weight_2_to_7.cu:570; rel
// 1e-5 + abs 3e-4 for the f32-accumulated gemv, gemv_w4a16_c32.cu:421-422).

#include <cinttypes>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

extern "C" {
void xbit_dequant_f16(const uint32_t*, const uint16_t*, const uint32_t*,
                      const int32_t*, int64_t, int64_t, int, int, int, uint16_t*);
void xbit_gemv_f16(const uint16_t*, const uint32_t*, const uint16_t*,
                   const uint32_t*, const int32_t*, int64_t, int64_t, int64_t, int,
                   int, int, uint16_t*);
float xbit_half_to_float(uint16_t);
}

namespace {

template <typename T>
std::vector<T> read_file(const std::string& path, size_t count) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    std::fprintf(stderr, "cannot open %s\n", path.c_str());
    std::exit(2);
  }
  std::vector<T> buf(count);
  size_t got = std::fread(buf.data(), sizeof(T), count, f);
  std::fclose(f);
  if (got != count) {
    std::fprintf(stderr, "%s: expected %zu elements, got %zu\n", path.c_str(),
                 count, got);
    std::exit(2);
  }
  return buf;
}

int compare_f16(const char* name, const std::vector<uint16_t>& got,
                const std::vector<uint16_t>& want, double atol, double rtol) {
  int bad = 0;
  double max_abs = 0;
  for (size_t i = 0; i < got.size(); ++i) {
    double a = xbit_half_to_float(got[i]), b = xbit_half_to_float(want[i]);
    double diff = std::fabs(a - b);
    max_abs = std::max(max_abs, diff);
    if (diff > atol + rtol * std::fabs(b)) {
      if (bad < 10)
        std::fprintf(stderr, "%s[%zu]: got %g want %g\n", name, i, a, b);
      ++bad;
    }
  }
  std::printf("%s: %d/%zu mismatches, max abs err %g\n", name, bad, got.size(),
              max_abs);
  return bad;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: %s <fixture_dir>\n", argv[0]);
    return 2;
  }
  std::string dir = argv[1];
  int64_t K, N, M;
  int bits, g, bias;
  {
    FILE* f = std::fopen((dir + "/shape.txt").c_str(), "r");
    if (!f || std::fscanf(f, "%" SCNd64 " %" SCNd64 " %d %d %d %" SCNd64, &K, &N,
                          &bits, &g, &bias, &M) != 6) {
      std::fprintf(stderr, "bad shape.txt\n");
      return 2;
    }
    std::fclose(f);
  }
  int64_t G = (K + g - 1) / g;
  auto input = read_file<uint16_t>(dir + "/input.bin", (size_t)(M * K));
  auto qweight =
      read_file<uint32_t>(dir + "/qweight.bin", (size_t)(((K * bits + 31) / 32) * N));
  auto scales = read_file<uint16_t>(dir + "/scales.bin", (size_t)(G * N));
  auto qzeros =
      read_file<uint32_t>(dir + "/qzeros.bin", (size_t)(G * ((N * bits + 31) / 32)));
  auto weight = read_file<uint16_t>(dir + "/weight.bin", (size_t)(K * N));
  auto golden = read_file<uint16_t>(dir + "/out.bin", (size_t)(M * N));

  std::vector<uint16_t> dq((size_t)(K * N));
  xbit_dequant_f16(qweight.data(), scales.data(), qzeros.data(), nullptr, K, N,
                   bits, g, bias, dq.data());
  int bad = compare_f16("dequant", dq, weight, 1e-3, 0.0);

  std::vector<uint16_t> out((size_t)(M * N));
  xbit_gemv_f16(input.data(), qweight.data(), scales.data(), qzeros.data(),
                nullptr, M, K, N, bits, g, bias, out.data());
  bad += compare_f16("gemv", out, golden, 3e-4, 1e-5);

  std::printf(bad ? "FAIL\n" : "PASS\n");
  return bad ? 1 : 0;
}
