// The plan of row 7's tensor-core tile route (res_tile.cuh) that the host
// needs: which shapes take the route, the output tile and its halo
// window, the channel chunk and the shared-memory swizzle, the ring of
// weight slices, each launch's shared memory, the dW1 tap groups, the
// partial-sum chunks (size and order) and the grids.  Plain C++ with no
// CUDA header, so the one definition is compiled into the kernels by nvcc
// and, for the CPU tests (tests/test_torch_res_plan.py), by a host
// compiler.
//
// Volumes on this route are channels-last (NDHWC: PyTorch's
// channels_last_3d strides on the logical (B, C, D, H, W) tensor), so a
// voxel's channels are one contiguous row and a tap's shift is a whole
// row of a staged window.

#pragma once

#ifdef __CUDACC__
#define RES_HD __host__ __device__
#else
#define RES_HD
#endif

namespace rp {

constexpr int kThreads = 256;      // 8 warps: the da launch
constexpr int kCoreThreads = 128;  // one warpgroup: the halo core (forward, dx)

// ---------------------------------------------------------------------------
// which shapes take the route
// ---------------------------------------------------------------------------

// The widest C and R: a product's N (R forward, C for dx) is one 128-column
// block tile.  Channels come in 16-byte rows of 8 bf16 values.
constexpr int kMaxCh = 128;
constexpr int kChAlign = 8;

// bf16 with C and R multiples of 8 up to 128 take the tile route; anything
// else (f32, odd or wider channels) keeps the GEMM kernels of res_stack.cu
RES_HD constexpr bool tile_route(int c, int r, int elem) {
  return elem == 2 && c >= kChAlign && r >= kChAlign && c <= kMaxCh && r <= kMaxCh &&
         c % kChAlign == 0 && r % kChAlign == 0;
}

// ---------------------------------------------------------------------------
// the output tile and its halo window
// ---------------------------------------------------------------------------

constexpr int kTZ = 4, kTY = 4, kTW = 8;  // output tile (z, y, x): 128 voxels
constexpr int kTM = kTZ * kTY * kTW;
constexpr int kWZ = kTZ + 2, kWY = kTY + 2, kWX = kTW + 2;  // its 3³ halo window
constexpr int kWin = kWZ * kWY * kWX;                       // 360 voxels

RES_HD constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// tiles of one volume (ragged at the far edges) and their walk: tile i of
// volume b has origin (z0, y0, x0); x fastest
RES_HD constexpr int tiles_z(int d) { return ceil_div(d, kTZ); }
RES_HD constexpr int tiles_y(int h) { return ceil_div(h, kTY); }
RES_HD constexpr int tiles_x(int w) { return ceil_div(w, kTW); }
RES_HD constexpr int tiles(int d, int h, int w) { return tiles_z(d) * tiles_y(h) * tiles_x(w); }

struct Origin {
  int b, z0, y0, x0;
};

// global tile index g over (volume, tile) → the tile's volume and origin
RES_HD inline Origin tile_origin(int g, int d, int h, int w) {
  const int nx = tiles_x(w), ny = tiles_y(h), nt = tiles(d, h, w);
  const int b = g / nt, i = g - b * nt;
  const int tz = i / (ny * nx), rem = i - tz * ny * nx, ty = rem / nx, tx = rem - ty * nx;
  return Origin{b, tz * kTZ, ty * kTY, tx * kTW};
}

// voxel m of a tile: (m / 32, m / 8 % 4, m % 8) from the origin
RES_HD constexpr int tile_z(int m) { return m / (kTY * kTW); }
RES_HD constexpr int tile_y(int m) { return m / kTW % kTY; }
RES_HD constexpr int tile_x(int m) { return m % kTW; }

// the window row of tile voxel m's centre (window origin: tile origin − 1)
RES_HD constexpr int win_centre(int m) {
  return ((tile_z(m) + 1) * kWY + tile_y(m) + 1) * kWX + tile_x(m) + 1;
}

// tap t = 9(dz + 1) + 3(dy + 1) + (dx + 1) of the 3³ conv: its shift in
// window rows
RES_HD constexpr int tap_dz(int t) { return t / 9 - 1; }
RES_HD constexpr int tap_dy(int t) { return t / 3 % 3 - 1; }
RES_HD constexpr int tap_dx(int t) { return t % 3 - 1; }
RES_HD constexpr int tap_shift(int t) { return (tap_dz(t) * kWY + tap_dy(t)) * kWX + tap_dx(t); }

// ---------------------------------------------------------------------------
// staged rows and their swizzle
// ---------------------------------------------------------------------------

constexpr int kKC = 64;  // channels of a staged window row: one chunk of K
constexpr int kNP = 128;  // columns of a product's block tile (N padded to 128)

// A staged row holds `cols` bf16 values (64 or 128: 8 or 16 chunks of 16
// bytes).  Chunk j of row v sits at chunk j ^ (v % 8): the 8 rows an
// ldmatrix phase reads (8 consecutive rows) fall on 8 distinct 16-byte
// bank groups.
RES_HD constexpr int swz(int row, int chunk) { return chunk ^ (row & 7); }
RES_HD constexpr int elem_at(int row, int col, int cols) {
  return row * cols + swz(row, col >> 3) * 8 + (col & 7);
}

// ---------------------------------------------------------------------------
// the halo core (forward and dx): steps, ring and shared memory (bytes)
// ---------------------------------------------------------------------------

// Chunks of the K channels (C forward, R for dx), each staged once as a
// window of kWin rows; then its 27 taps, one weight slice (kNP x kKC) a
// step, through a ring of kStages slots: the copies of the next kStages −
// 1 slices are in flight while a step's products run.  Step s = 27·chunk +
// tap.
constexpr int kStages = 3;
RES_HD constexpr int chunks(int k) { return ceil_div(k, kKC); }
RES_HD constexpr int core_steps(int k) { return 27 * chunks(k); }

constexpr int kWinBytes = kWin * kKC * 2;      // 46080
constexpr int kSliceBytes = kNP * kKC * 2;     // 16384
constexpr int kTileBytes = kTM * kNP * 2;      // a 128 x 128 bf16 tile: 32768
static_assert(kTileBytes <= kWinBytes, "the h / output tile reuses the window");
static_assert(kNP * kNP * 2 <= kStages * kSliceBytes, "W2 reuses the ring");

constexpr int kCoreSmem = kWinBytes + kStages * kSliceBytes;  // 95232: two blocks an SM

// ---------------------------------------------------------------------------
// da (with the dW2, db1 and db2 partials): 128 voxels a sub-tile
// ---------------------------------------------------------------------------

// W2ᵀ (R x C), then two slots of a sub-tile's y (then g_r), gy (then da)
// and h tiles: the copies of the next sub-tile are in flight while one is
// multiplied
constexpr int kDaSmem = 7 * kTileBytes;  // 229376

// the sub-tiles are 128 consecutive voxels of the flattened (B·D·H·W)
// volume; kDaChunks chunks of whole sub-tiles, in increasing order
constexpr int kDaChunks = 264;  // two waves of one block on each of the H100's 132 SMs

// ---------------------------------------------------------------------------
// dW1: one block per (tap group, 64 channels of x, chunk of tiles)
// ---------------------------------------------------------------------------

// Group g holds the three taps that share (dz, dy) = (g / 3 − 1, g % 3 − 1):
// taps 3g, 3g + 1, 3g + 2 (dx = −1, 0, 1).  For a tile, the group reads
// one x window of kTZ x kTY x kWX rows, shifted by (dz, dy), and each tap
// a shift of 0, 1 or 2 rows of it.
constexpr int kGroups = 9;
constexpr int kGroupTaps = 3;
RES_HD constexpr int group_tap(int g, int i) { return kGroupTaps * g + i; }
constexpr int kXRows = kTZ * kTY * kWX;  // 160

constexpr int kCB = 64;  // x channels (the product's M) of one dW1 block
RES_HD constexpr int c_blocks(int c) { return ceil_div(c, kCB); }
constexpr int kDw1Threads = 32 * 4 * kGroupTaps;  // a warpgroup a tap of the group

// the row of a group's x window holding tile voxel m shifted by dx
RES_HD constexpr int xrow(int m, int dx) {
  return (tile_z(m) * kTY + tile_y(m)) * kWX + tile_x(m) + 1 + dx;
}

// a tile's x window and da tile (two 64-channel halves of 128-byte rows:
// wgmma's MN-major B), staged through a ring of kDw1Stages slots: the
// copies of the next three tiles are in flight while one is multiplied
// (one block an SM)
constexpr int kXWinBytes = kXRows * kCB * 2;        // 20480
constexpr int kDw1Stage = kXWinBytes + kTileBytes;  // x window + da tile: 53248
constexpr int kDw1Stages = 4;
constexpr int kDw1Smem = kDw1Stages * kDw1Stage;  // 212992

// chunks of whole tiles over the (volume, tile) walk, in increasing order:
// 44 chunks x 9 groups x 2 channel blocks = 792 blocks, six whole waves of
// one block on each of 132 SMs at C = 128
constexpr int kDw1Chunks = 44;

// tiles in a chunk, and the number of chunks, for n tiles in all
RES_HD constexpr int chunk_len(int n, int want) { return ceil_div(n, want < n ? want : n); }
RES_HD constexpr int chunk_count(int n, int want) { return ceil_div(n, chunk_len(n, want)); }

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Grid {
  int x, y, z;
};

// forward and dx: one block a tile, (volume, tile) in walk order
RES_HD inline Grid core_grid(int b, int d, int h, int w) { return Grid{b * tiles(d, h, w), 1, 1}; }

// dW1: (tap group, channel block, chunk), the group fastest: the blocks of
// a chunk start together and share its tiles through L2
RES_HD inline Grid dw1_grid(int c, int nchunks) { return Grid{kGroups, c_blocks(c), nchunks}; }

// the largest dynamic shared memory of the route's launches
constexpr int kMaxSmem =
    kCoreSmem > kDaSmem ? (kCoreSmem > kDw1Smem ? kCoreSmem : kDw1Smem)
                        : (kDaSmem > kDw1Smem ? kDaSmem : kDw1Smem);

// Partial sums (floats): kDw1 chunks of dW1 (27·C·R each), then the da
// kernel's chunks of dW2 (R·C), db1 (R) and db2 (C).
RES_HD inline long long part1_floats(int c, int r) { return 27LL * c * r; }
RES_HD inline long long part2_floats(int c, int r) { return (long long)r * c + r + c; }
RES_HD inline int dw1_chunks(int b, int d, int h, int w) {
  return chunk_count(b * tiles(d, h, w), kDw1Chunks);
}
RES_HD inline int da_chunks(int b, int d, int h, int w) {
  return chunk_count(ceil_div(b * d * h * w, kTM), kDaChunks);
}
RES_HD inline long long part_floats(int b, int c, int r, int d, int h, int w) {
  return dw1_chunks(b, d, h, w) * part1_floats(c, r) + da_chunks(b, d, h, w) * part2_floats(c, r);
}

}  // namespace rp
