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
//   - one baseline Huffman-coded JPEG scan decoded into quantized DCT
//     coefficients (ITU T.81 F.2.2, restart intervals included), for the
//     JPEG decoder of oadg_tpu_torch/utils/jpeg.py
//
// Built with g++ at first use by oadg_tpu_torch/utils/host_kernels.py
// into oadg_tpu_torch/_build/ and loaded with ctypes, which releases the
// interpreter lock around each call.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <climits>
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

namespace {

// One Huffman table of a scan: a 9-bit lookahead (length << 8 | symbol, 0
// for a longer code) and, for codes of 10-16 bits, the largest code of each
// length with the offset of its symbols (T.81 F.2.2.3).
struct HuffTable {
    uint16_t look[1 << 9];
    int32_t maxcode[17];
    int32_t valoffset[17];
    const uint8_t* vals;
    bool defined;
};

// Build from 16 BITS counts and 256 HUFFVAL bytes; false if the counts
// overflow a code length (an invalid table).
bool build_huff(const uint8_t* t, HuffTable* h) {
    const uint8_t* bits = t;
    h->vals = t + 16;
    h->defined = false;
    std::memset(h->look, 0, sizeof(h->look));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
        h->valoffset[len] = k - code;
        for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
            if (code >= (1 << len) || k >= 256) return false;
            if (len <= 9) {
                const int lo = code << (9 - len);
                for (int j = 0; j < (1 << (9 - len)); ++j)
                    h->look[lo + j] = static_cast<uint16_t>(len << 8 | h->vals[k]);
            }
        }
        h->maxcode[len] = bits[len - 1] ? code - 1 : -1;
        code <<= 1;
    }
    h->defined = k > 0;
    return true;
}

// MSB-first bit reader over entropy-coded bytes: removes the 0x00 after
// each 0xFF and stops at a marker (or the end), feeding zero bits past it.
// `zeros` counts those padding bits at the end of `buf`, so that a decode
// reading into them is caught.
struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t buf = 0;
    int bits = 0;
    int zeros = 0;

    void fill() {
        while (bits <= 56) {
            uint64_t b = 0;
            if (p < end && !(*p == 0xFF && !(p + 1 < end && p[1] == 0x00))) {
                b = *p;
                p += *p == 0xFF ? 2 : 1;
            } else {
                zeros += 8;
            }
            buf |= b << (56 - bits);
            bits += 8;
        }
    }
    uint32_t peek(int n) const { return static_cast<uint32_t>(buf >> (64 - n)); }
    void skip(int n) { buf <<= n; bits -= n; }
    bool overrun() const { return bits < zeros; }
    void reset() { buf = 0; bits = 0; zeros = 0; }
};

// The next symbol of table t, or -1 for an invalid code.
int decode_symbol(BitReader& r, const HuffTable& t) {
    const int e = t.look[r.peek(9)];
    if (e) {
        r.skip(e >> 8);
        return e & 0xFF;
    }
    const int32_t peek16 = static_cast<int32_t>(r.peek(16));
    for (int len = 10; len <= 16; ++len) {
        const int32_t code = peek16 >> (16 - len);
        if (code <= t.maxcode[len]) {
            r.skip(len);
            return t.vals[code + t.valoffset[len]];
        }
    }
    return -1;
}

// s extra bits as a signed value (T.81 F.2.2.1 EXTEND).
int receive_extend(BitReader& r, int s) {
    if (s == 0) return 0;
    int v = static_cast<int>(r.peek(s));
    r.skip(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

}  // namespace

extern "C" {

// Decode one baseline Huffman-coded scan (8-bit samples) into quantized
// DCT coefficients. data/len: the scan's entropy-coded bytes, restart
// markers included, up to the next other marker. comps: ncomps x 5 int32
// per scan component: blocks across and down an MCU (1, 1 in a scan of one
// component), DC table slot 0-3, AC table slot 0-3, blocks a row of its
// coefficient array. tables: 8 x 272 bytes, DC slots 0-3 then AC slots
// 0-3, each 16 BITS counts and 256 HUFFVAL bytes. coefs: per component an
// int16 array of (rows, blocks a row, 64) coefficients in natural order,
// written at the MCU grid's blocks. restart_interval: MCUs between RSTn
// markers, 0 for none. Returns 0; 1 an invalid Huffman code; 2 data that
// ends early; 3 a missing or out-of-order restart marker; 4 a run of AC
// coefficients past the 64th; 5 a table that is not defined or invalid.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t len, const int32_t* comps,
                         int64_t ncomps, const uint8_t* tables, int64_t mcus_x,
                         int64_t mcus_y, int64_t restart_interval,
                         int16_t* const* coefs) {
    if (ncomps < 1 || ncomps > 4) return 5;
    HuffTable huff[8];
    for (int i = 0; i < 8; ++i)
        if (!build_huff(tables + i * 272, &huff[i])) huff[i].defined = false;
    for (int64_t c = 0; c < ncomps; ++c) {
        const int32_t* d = comps + c * 5;
        if (d[2] < 0 || d[2] > 3 || d[3] < 0 || d[3] > 3 ||
            !huff[d[2]].defined || !huff[4 + d[3]].defined) return 5;
    }
    BitReader r{data, data + len};
    int pred[4] = {0, 0, 0, 0};
    const int64_t total = mcus_x * mcus_y;
    int next_rst = 0;
    for (int64_t mcu = 0; mcu < total; ++mcu) {
        if (restart_interval > 0 && mcu > 0 && mcu % restart_interval == 0) {
            r.reset();
            while (r.p + 1 < r.end && !(r.p[0] == 0xFF && r.p[1] >= 0xD0 && r.p[1] <= 0xD7))
                ++r.p;
            if (r.p + 1 >= r.end || r.p[1] != 0xD0 + (next_rst & 7)) return 3;
            r.p += 2;
            ++next_rst;
            for (int c = 0; c < 4; ++c) pred[c] = 0;
        }
        const int64_t my = mcu / mcus_x, mx = mcu % mcus_x;
        for (int64_t c = 0; c < ncomps; ++c) {
            const int32_t* d = comps + c * 5;
            const HuffTable& dc = huff[d[2]];
            const HuffTable& ac = huff[4 + d[3]];
            for (int yy = 0; yy < d[1]; ++yy) {
                for (int xx = 0; xx < d[0]; ++xx) {
                    int16_t* blk = coefs[c] + ((my * d[1] + yy) * static_cast<int64_t>(d[4])
                                               + mx * d[0] + xx) * 64;
                    r.fill();
                    const int s = decode_symbol(r, dc);
                    if (s < 0) return 1;
                    pred[c] += receive_extend(r, s);
                    blk[0] = static_cast<int16_t>(pred[c]);
                    for (int k = 1; k < 64;) {
                        r.fill();
                        const int rs = decode_symbol(r, ac);
                        if (rs < 0) return 1;
                        const int run = rs >> 4, size = rs & 15;
                        if (size == 0) {
                            if (run != 15) break;
                            k += 16;
                            continue;
                        }
                        k += run;
                        if (k > 63) return 4;
                        blk[kZigzag[k]] = static_cast<int16_t>(receive_extend(r, size));
                        ++k;
                    }
                    if (r.overrun()) return 2;
                }
            }
        }
    }
    return 0;
}

}  // extern "C"
