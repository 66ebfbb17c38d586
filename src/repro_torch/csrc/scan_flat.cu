// K2: flat prefix scan of (n,) leaves under any device operator.
//
// Replaces: src/repro/kernels/scan.py::scan_1d_pallas (body _scan1d_kernel and
// block_scan_rowmajor), which walks the array on the TPU's sequential grid
// with a running carry in VMEM.
//
// Bound on this card: memory.  The least traffic is one read and one write of
// every element (2 n x element bytes at 3.35 TB/s).  Hopper blocks run in no
// order, so the TPU's sequential carry does not carry over.  This first
// version is the three-phase form of tile_scan.cuh (reduce, scan of the tile
// totals, rescan), exact for non-commutative operators, over one row: it
// moves 3 n element bytes instead of 2 n.  For n <= TILE (the serving path's
// (B,) count scan) it is a single launch with no carry.  The single-pass
// Merrill-Garland decoupled lookback, with a real acquire spin on the status
// flags, is the later performance step.
#include "tile_scan.cuh"

extern "C" {

// Elements per block; the caller sizes `scratch` to cdiv(n, TILE) elements
// (8 bytes each for AFFINE, 4 otherwise) when n > TILE.
int rt_scan_flat_tile() { return rt::tile::TILE; }

// Returns a cudaError_t code: 0 on a clean launch.
int rt_scan_flat(int op, int dtype, const void* x0, const void* x1, void* y0,
                 void* y1, long n, int inclusive, void* scratch,
                 void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_ALL(op, dtype,
                  return rt::tile::launch_scan_rows<T, OP>(
                      x0, x1, y0, y1, 1, n, inclusive != 0, scratch, st));
  return cudaErrorInvalidValue;
}

}  // extern "C"
