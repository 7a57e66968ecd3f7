// Host kernels of the port's evaluation and image loading (C++, ctypes ABI).
//
// The port's copy of the JAX package's native evaluation kernels, plus the
// PNG row unfilter of the port's image decoder
// (oadg_tpu_torch/data/pipelines/image_io.py):
//
//   - pairwise IoU (xyxy, optional VOC +1 legacy widths; xywh with COCO
//     crowd semantics)
//   - greedy score-ordered det<->gt matching at one IoU threshold
//     (VOC tp/fp, mean_ap.py tpfp_default)
//   - COCO-protocol matching across T thresholds with ignore/crowd
//     handling (coco_eval.py _evaluate_img)
//   - the five PNG row filters undone (PNG specification, section 9)
//
// Built with g++ at first use by oadg_tpu_torch/utils/host_kernels.py
// into oadg_tpu_torch/_build/ and loaded with ctypes, which releases the
// interpreter lock around each call.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Pairwise IoU of dets (D,4 xyxy) vs gts (G,4 xyxy); extra = 1.0 for VOC
// legacy coordinates. Output (D*G) row-major.
void iou_xyxy(const float* dets, int64_t d, const float* gts, int64_t g,
              float extra, float* out) {
    for (int64_t i = 0; i < d; ++i) {
        const float dx1 = dets[i * 4], dy1 = dets[i * 4 + 1];
        const float dx2 = dets[i * 4 + 2], dy2 = dets[i * 4 + 3];
        const float da = (dx2 - dx1 + extra) * (dy2 - dy1 + extra);
        for (int64_t j = 0; j < g; ++j) {
            const float gx1 = gts[j * 4], gy1 = gts[j * 4 + 1];
            const float gx2 = gts[j * 4 + 2], gy2 = gts[j * 4 + 3];
            const float ga = (gx2 - gx1 + extra) * (gy2 - gy1 + extra);
            const float iw = std::max(0.f, std::min(dx2, gx2)
                                      - std::max(dx1, gx1) + extra);
            const float ih = std::max(0.f, std::min(dy2, gy2)
                                      - std::max(dy1, gy1) + extra);
            const float inter = iw * ih;
            const float uni = std::max(da + ga - inter, 1e-10f);
            out[i * g + j] = inter / uni;
        }
    }
}

// Pairwise IoU of xywh boxes with crowd semantics: for crowd gts the
// denominator is the det area (pycocotools iou).
void iou_xywh_crowd(const float* dets, int64_t d, const float* gts, int64_t g,
                    const uint8_t* iscrowd, float* out) {
    for (int64_t i = 0; i < d; ++i) {
        const float dx1 = dets[i * 4], dy1 = dets[i * 4 + 1];
        const float dw = dets[i * 4 + 2], dh = dets[i * 4 + 3];
        const float da = dw * dh;
        for (int64_t j = 0; j < g; ++j) {
            const float gx1 = gts[j * 4], gy1 = gts[j * 4 + 1];
            const float gw = gts[j * 4 + 2], gh = gts[j * 4 + 3];
            const float iw = std::max(0.f, std::min(dx1 + dw, gx1 + gw)
                                      - std::max(dx1, gx1));
            const float ih = std::max(0.f, std::min(dy1 + dh, gy1 + gh)
                                      - std::max(dy1, gy1));
            const float inter = iw * ih;
            const float uni = iscrowd[j] ? da
                                         : std::max(da + gw * gh - inter,
                                                    1e-10f);
            out[i * g + j] = uni > 0 ? inter / uni : 0.f;
        }
    }
}

// VOC-style greedy matching (reference mean_ap.py tpfp_default semantics):
// dets pre-scored (scores array), gts with ignore flags; each det matches
// its max-IoU gt if >= thr; ignored gts absorb dets (neither tp nor fp).
// tp/fp are (D,) float outputs aligned with det order.
void tpfp_greedy(const float* ious, const float* scores, int64_t d, int64_t g,
                 const uint8_t* gt_ignore, float iou_thr, float* tp,
                 float* fp) {
    std::vector<int64_t> order(d);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return scores[a] > scores[b]; });
    std::vector<uint8_t> covered(g, 0);
    for (int64_t k = 0; k < d; ++k) {
        const int64_t i = order[k];
        tp[i] = 0.f;
        fp[i] = 0.f;
        if (g == 0) { fp[i] = 1.f; continue; }
        float best = -1.f;
        int64_t bj = -1;
        for (int64_t j = 0; j < g; ++j) {
            if (ious[i * g + j] > best) { best = ious[i * g + j]; bj = j; }
        }
        if (best >= iou_thr) {
            if (gt_ignore && gt_ignore[bj]) continue;   // ignored: skip
            if (!covered[bj]) { covered[bj] = 1; tp[i] = 1.f; }
            else fp[i] = 1.f;
        } else {
            fp[i] = 1.f;
        }
    }
}

// COCO-protocol matching for one (img, cat, areaRng): dets sorted by score
// DESC already; T thresholds. Outputs per (t, det): matched gt index or -1,
// and det-ignore flags. gt_ignore combines area-range + crowd ignores; gts
// must be ordered non-ignored first (pycocotools gtind ordering).
void coco_match(const float* ious, int64_t d, int64_t g,
                const uint8_t* gt_ignore, const uint8_t* gt_crowd,
                const float* thrs, int64_t t,
                int32_t* dt_match, uint8_t* dt_ignore) {
    std::vector<int32_t> gtm(t * g, -1);
    for (int64_t ti = 0; ti < t; ++ti) {
        const float thr = thrs[ti];
        for (int64_t di = 0; di < d; ++di) {
            float best = std::min(thr, 1.f - 1e-10f);
            int64_t bg = -1;
            for (int64_t gi = 0; gi < g; ++gi) {
                if (gtm[ti * g + gi] >= 0 && !gt_crowd[gi]) continue;
                if (bg >= 0 && !gt_ignore[bg] && gt_ignore[gi]) break;
                if (ious[di * g + gi] < best) continue;
                best = ious[di * g + gi];
                bg = gi;
            }
            dt_match[ti * d + di] = static_cast<int32_t>(bg);
            dt_ignore[ti * d + di] = bg >= 0 ? gt_ignore[bg] : 0;
            if (bg >= 0) gtm[ti * g + bg] = static_cast<int32_t>(di);
        }
    }
}

// Undo the PNG row filters of h scanlines. src holds each row's filter-type
// byte followed by its `stride` filtered bytes; dst receives the h rows of
// `stride` reconstructed bytes; a pixel is `bpp` bytes. Filters: 0 None,
// 1 Sub, 2 Up, 3 Average, 4 Paeth, each relative to the reconstructed
// bytes to the left (a), above (b) and above-left (c), 0 outside the image.
// Returns 0, or 1 + the first row whose filter type is not one of these.
int64_t png_unfilter(const uint8_t* src, int64_t h, int64_t stride,
                     int64_t bpp, uint8_t* dst) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t type = src[y * (stride + 1)];
        const uint8_t* f = src + y * (stride + 1) + 1;
        uint8_t* r = dst + y * stride;
        const uint8_t* up = y > 0 ? r - stride : nullptr;
        switch (type) {
        case 0:
            std::memcpy(r, f, stride);
            break;
        case 1:
            for (int64_t x = 0; x < stride; ++x)
                r[x] = static_cast<uint8_t>(f[x] + (x >= bpp ? r[x - bpp] : 0));
            break;
        case 2:
            for (int64_t x = 0; x < stride; ++x)
                r[x] = static_cast<uint8_t>(f[x] + (up ? up[x] : 0));
            break;
        case 3:
            for (int64_t x = 0; x < stride; ++x) {
                const int a = x >= bpp ? r[x - bpp] : 0;
                const int b = up ? up[x] : 0;
                r[x] = static_cast<uint8_t>(f[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t x = 0; x < stride; ++x) {
                const int a = x >= bpp ? r[x - bpp] : 0;
                const int b = up ? up[x] : 0;
                const int c = (up && x >= bpp) ? up[x - bpp] : 0;
                const int p = a + b - c;
                const int pa = std::abs(p - a), pb = std::abs(p - b),
                          pc = std::abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                r[x] = static_cast<uint8_t>(f[x] + pred);
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}

}  // extern "C"
