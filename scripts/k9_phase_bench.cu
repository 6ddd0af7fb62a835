// What one phase of K9 (uzliti_slam_tpu_torch/csrc/chain_factor.cu) costs
// on the card: a grid.sync of a cooperative grid of 86, 132 and 264 CTAs,
// one round of K9's 6x6 inverse pair in one CTA (its barriers and
// dependent float64 divisions), a chain of float64 divisions and a chain
// of CTA barriers; one JSON line each, CUDA events, one CUDA card.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o build/k9_phase_bench scripts/k9_phase_bench.cu && build/k9_phase_bench
#include "../uzliti_slam_tpu_torch/csrc/chain_factor.cu"

#include <cstdio>

__global__ void k_sync(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}
__global__ void __launch_bounds__(kBlockThreads) k_inv(int n, double* out) {
  __shared__ LevelGroup G[kGroups];
  const int t = threadIdx.x % 36, g = threadIdx.x / 36;
  G[g].Do[t] = (t / 6 == t % 6) ? 4.0 : 0.1;
  G[g].Dom[t] = G[g].Do[t] + 0.5;
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    inv6_pair(G[g].Do, G[g].Dom, 0.0, G[g].Di, G[g].Dim, G[g].s0, G[g].s1, t);
    G[g].Do[t] = G[g].Di[t] + 1.0;
    __syncthreads();
  }
  out[threadIdx.x] = G[g].Di[t];
}
__global__ void __launch_bounds__(kBlockThreads) k_div(int n, double* out) {
  double x = 1.0 + threadIdx.x;
  for (int i = 0; i < n; ++i) x = 3.0 / (x + 1.0);
  out[threadIdx.x] = x;
}
__global__ void __launch_bounds__(kBlockThreads) k_bar(int n, double* out) {
  double x = 1.0 + threadIdx.x;
  for (int i = 0; i < n; ++i) { x = x * 0.999 + 0.001; __syncthreads(); }
  out[threadIdx.x] = x;
}
int main() {
  double* out; cudaMalloc(&out, 4096 * sizeof(double));
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  float ms;
  for (int grid : {86, 132, 264}) {
    int n = 200; void* args[] = {&n};
    cudaLaunchCooperativeKernel((void*)k_sync, grid, kBlockThreads, args, 0, 0);
    cudaEventRecord(a);
    cudaLaunchCooperativeKernel((void*)k_sync, grid, kBlockThreads, args, 0, 0);
    cudaEventRecord(b); cudaEventSynchronize(b); cudaEventElapsedTime(&ms, a, b);
    printf("{\"grid_sync_us\": %f, \"grid\": %d, \"err\": \"%s\"}\n", 1e3 * ms / n, grid, cudaGetErrorString(cudaGetLastError()));
  }
  for (int n : {0, 100}) {
    k_inv<<<1, kBlockThreads>>>(n, out);
    cudaEventRecord(a); k_inv<<<1, kBlockThreads>>>(n, out); cudaEventRecord(b);
    cudaEventSynchronize(b); cudaEventElapsedTime(&ms, a, b);
    printf("{\"inv6_pair_rounds\": %d, \"total_us\": %f}\n", n, 1e3 * ms);
  }
  for (int n : {0, 1000}) {
    k_div<<<1, kBlockThreads>>>(n, out);
    cudaEventRecord(a); k_div<<<1, kBlockThreads>>>(n, out); cudaEventRecord(b);
    cudaEventSynchronize(b); cudaEventElapsedTime(&ms, a, b);
    printf("{\"ddiv_chain\": %d, \"total_us\": %f}\n", n, 1e3 * ms);
    k_bar<<<1, kBlockThreads>>>(n, out);
    cudaEventRecord(a); k_bar<<<1, kBlockThreads>>>(n, out); cudaEventRecord(b);
    cudaEventSynchronize(b); cudaEventElapsedTime(&ms, a, b);
    printf("{\"barrier_chain\": %d, \"total_us\": %f}\n", n, 1e3 * ms);
  }
  int clk = 0; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  printf("{\"clock_khz\": %d}\n", clk);
  return 0;
}
