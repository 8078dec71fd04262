// DET fixture for the CUDA sources: atomics whose order the hardware does
// not fix (read as text, comments and literals stripped; never compiled).
// A comment that names atomicAdd(x, 1) is not a call.

__global__ void float_sum(const float* x, float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(out, x[i]);  // expect[DET]
}

__global__ void float_sum_block(const float* x, float* out, int n) {
  int i = threadIdx.x;
  if (i < n) atomicAdd_block(out, x[i]);  // expect[DET]
}

__global__ void spin_lock(int* lock) {
  while (atomicCAS(lock, 0, 1) != 0) {  // expect[DET]
  }
  atomicSub(lock, 1);  // expect[DET]
}

__global__ void last_writer(const float* x, float* out, int n) {
  int i = threadIdx.x;
  if (i < n) atomicExch(out, x[i]);  // expect[DET]
}

/* A block comment
   that names atomicAdd(out, 1.0f) spans lines. */
__global__ void fixed_order_sum_ok(const float* x, float* out, int n) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc += x[i];
  out[0] = acc;
  printf("atomicAdd(out, acc) is only text here\n");
}

__global__ void integer_count(const int* bin, int* hist, int n) {
  int i = threadIdx.x;
  if (i < n) atomicAdd(hist + bin[i], 1);  // repro: allow[DET]: fixture — integer addition is exact in any order
}
