// The tile of the fused fusion-net decoder head (K4), shared by its two
// routes: float32 on the CUDA cores (fusion_head.cu) and bfloat16 on the
// tensor cores (fusion_head_tc.cu).
//
// A block owns a TH x TW tile of flow0 (and the HT x WT tile of flow1 under
// it) and recomputes the halo the chain of layers needs. Regions are rows x
// columns, with their origin relative to the tile's: (y0, x0) at full
// resolution, (m0, n0) = (y0 / 2, x0 / 2) at half resolution.
#pragma once

namespace fusion_head {

constexpr int kThreads = 512;
constexpr int TH = 32, TW = 32;          // flow0 tile (full resolution)
constexpr int HT = TH / 2, WT = TW / 2;  // flow1 tile (half resolution)
constexpr int C1 = 162, CI1 = 32, CD = 16, C0 = 64, CI0 = 16;

// half resolution
constexpr int XA_R = HT + 8, XA_C = WT + 8;  // concat1 window of inter_conv1, origin -4
constexpr int I1_R = HT + 6, I1_C = WT + 6;  // inter1, origin -3
constexpr int F1_R = HT + 4, F1_C = WT + 4;  // flow1, origin -2
constexpr int XB_R = F1_R, XB_C = F1_C;      // concat1 window of deconv0, origin -2
constexpr int PH_R = HT + 2, PH_C = WT + 2;  // one deconv phase's positions, origin -1
// full resolution
constexpr int UP_R = TH + 4, UP_C = TW + 4;  // upfeat, upflow and the c0 window, origin -2
constexpr int I0_R = TH + 2, I0_C = TW + 2;  // inter0, origin -1
constexpr int N_I1 = I1_R * I1_C, N_F1 = F1_R * F1_C, N_PH = PH_R * PH_C, N_UP = UP_R * UP_C,
              N_I0 = I0_R * I0_C;
static_assert(2 * PH_R == UP_R && 2 * PH_C == UP_C, "the four deconv phases tile the upfeat region");

}  // namespace fusion_head
