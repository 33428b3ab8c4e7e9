// zstd sequence execution (X1) for Hopper (sm_90a), bound through ctypes.
//
// A kernel of the port alone: in stenos_tpu this work is XLA glue, not
// Pallas (stenos_tpu/entropy/seq_exec.py::run_programs executes a host-built
// program of W-byte copy ops in rounds of one gather and one scatter). In
// torch such a round loop costs two launches a round, ~30-45k rounds a
// 128 KiB block, so the sequences execute here directly.
//
// One warp per lane; a lane runs its blocks in order. For each sequence
// (ll, ml, off) the warp copies ll literals in parallel, then the match:
// out[p + i] = out[p - off + (i % off)] for i < ml. Every source byte lies
// before p and is final, so an overlapping match (off < ml) is one parallel
// copy too; the warp synchronises between the two steps and between
// sequences. Trailing literals follow the last sequence. With `staged` set,
// every lane is one block whose matches stay inside it (the caller checked)
// and the block is built in shared memory (<= 128 KiB) and written out in
// coalesced stores; otherwise the lane works in device memory, where a
// match may read earlier blocks of the frame.
//
// Bound: bytes (literals and sequences in, the output written once). The
// real limit is the serial chain of one warp per block: two warp barriers
// and a dependent shared-memory round trip a sequence.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kBlockCols = 6;  // out_off, out_len, lit_off, lit_len, seq_off, nseq
constexpr int kMaxStaged = 131072;

__global__ void __launch_bounds__(32)
seq_exec(uint8_t* out, const uint8_t* __restrict__ lits,
         const int* __restrict__ ll, const int* __restrict__ ml,
         const int* __restrict__ off, const long long* __restrict__ blocks,
         const long long* __restrict__ lanes, int staged) {
    extern __shared__ uint8_t s_out[];
    const int t = threadIdx.x;
    const long long b0 = lanes[2 * blockIdx.x], b1 = lanes[2 * blockIdx.x + 1];
    for (long long b = b0; b < b1; ++b) {
        const long long* blk = blocks + b * kBlockCols;
        const long long out_len = blk[1], lit_len = blk[3];
        const long long seq0 = blk[4], nseq = blk[5];
        uint8_t* o = staged ? s_out : out + blk[0];
        const uint8_t* lp = lits + blk[2];
        const uint8_t* lit_end = lp + lit_len;
        long long pos = 0;
        for (long long g = 0; g < nseq; g += 32) {
            int my_ll = 0, my_ml = 0, my_off = 1;
            if (g + t < nseq) {
                my_ll = ll[seq0 + g + t];
                my_ml = ml[seq0 + g + t];
                my_off = off[seq0 + g + t];
            }
            const int cnt = nseq - g < 32 ? (int)(nseq - g) : 32;
            for (int k = 0; k < cnt; ++k) {
                const int l = __shfl_sync(0xffffffffu, my_ll, k);
                const int m = __shfl_sync(0xffffffffu, my_ml, k);
                const int d = __shfl_sync(0xffffffffu, my_off, k);
                for (int j = t; j < l; j += 32) o[pos + j] = lp[j];
                lp += l;
                pos += l;
                __syncwarp();
                const uint8_t* src = o + pos - d;
                if (d >= m) {
                    for (int j = t; j < m; j += 32) o[pos + j] = src[j];
                } else {
                    for (int j = t; j < m; j += 32) o[pos + j] = src[j % d];
                }
                pos += m;
                __syncwarp();
            }
        }
        const long long rest = lit_end - lp;
        for (long long j = t; j < rest; j += 32) o[pos + j] = lp[j];
        if (staged) {
            __syncwarp();
            uint8_t* dst = out + blk[0];
            for (long long j = t; j < out_len; j += 32) dst[j] = s_out[j];
            __syncwarp();
        }
    }
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers: out (the frame's
// output, direct pieces already in place), lits, the (total,) int32 ll, ml
// and resolved offsets, blocks (nblk, 6) int64, lanes (nlanes, 2) int64
// block ranges. staged_bytes > 0 stages each lane's single block of at most
// that many bytes in shared memory. The launch goes on `stream`; the return
// value is the first CUDA error of the call (0 when none).
extern "C" int stenos_seq_exec(void* out, const void* lits, const void* ll,
                               const void* ml, const void* off,
                               const void* blocks, const void* lanes,
                               long long nlanes, long long staged_bytes,
                               void* stream) {
    if (staged_bytes > kMaxStaged) return (int)cudaErrorInvalidValue;
    const int shared = (int)staged_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        seq_exec, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStaged);
    if (err != cudaSuccess) return (int)err;
    seq_exec<<<(unsigned)nlanes, 32, shared, (cudaStream_t)stream>>>(
        (uint8_t*)out, (const uint8_t*)lits, (const int*)ll, (const int*)ml,
        (const int*)off, (const long long*)blocks, (const long long*)lanes,
        shared > 0);
    return (int)cudaGetLastError();
}
#endif
