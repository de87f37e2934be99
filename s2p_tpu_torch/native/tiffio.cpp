// Native TIFF window reader of the PyTorch port (a copy of the JAX
// package's s2p_tpu/native/tiffio.cpp, with its faults repaired).
//
// Memory-maps a classic or Big TIFF, parses its first IFD and decodes a
// pixel window of a strip- or tile-organised raster, touching only the
// chunks that meet the window: compression none, deflate or PackBits, the
// horizontal-difference predictor, chunky samples of 1, 2, 4 or 8 bytes,
// either byte order.  The area outside the raster is zero.
//
// What the JAX package's copy does otherwise, and this one does not:
//   * it ignores a predictor other than 2 (the floating-point predictor 3
//     returns undecoded bytes); this one refuses every predictor but 1
//     and 2, and undoes predictor 2 on 8-byte samples too;
//   * it copies big-endian samples without swapping their bytes;
//   * it copies the padding rows of a bottom tile into a boundless
//     window below the raster;
//   * a window wholly left of the raster makes it copy a negative length;
//   * a rows-per-strip larger than the raster sizes its buffer by the tag;
//   * a short or corrupt chunk leaves an earlier chunk's bytes in place.
// Anything refused returns a negative code, and the caller reads the file
// with the Python decoder.
//
// C ABI for ctypes (s2p_tpu_torch/geo/geotiff_native.py), which builds it
// at first use:  g++ -O3 -Wall -fPIC -std=c++17 -shared tiffio.cpp -lz

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <vector>

namespace {

struct Reader {
    const uint8_t* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool little = true;
    bool big_tiff = false;

    uint64_t width = 0, height = 0;
    uint32_t spp = 1, bps = 8, sample_format = 1;
    uint32_t compression = 1, predictor = 1, planar = 1;
    uint64_t rows_per_strip = 0, tile_w = 0, tile_h = 0;
    std::vector<uint64_t> chunk_offsets;
    std::vector<uint64_t> chunk_counts;

    ~Reader() {
        if (data) munmap(const_cast<uint8_t*>(data), size);
        if (fd >= 0) close(fd);
    }

    uint64_t rd(const uint8_t* p, int n) const {
        uint64_t v = 0;
        if (little) {
            for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
        } else {
            for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
        }
        return v;
    }
};

int type_size(uint16_t t) {
    switch (t) {
        case 1: case 2: case 6: case 7: return 1;
        case 3: case 8: return 2;
        case 4: case 9: case 11: return 4;
        case 5: case 10: case 12: case 16: case 17: return 8;
        default: return 0;
    }
}

bool parse(Reader& r) {
    const uint8_t* d = r.data;
    if (r.size < 16) return false;
    if (d[0] == 'I' && d[1] == 'I') r.little = true;
    else if (d[0] == 'M' && d[1] == 'M') r.little = false;
    else return false;
    uint64_t magic = r.rd(d + 2, 2);
    uint64_t ifd;
    if (magic == 43) {
        r.big_tiff = true;
        ifd = r.rd(d + 8, 8);
    } else if (magic == 42) {
        ifd = r.rd(d + 4, 4);
    } else {
        return false;
    }
    const int esz = r.big_tiff ? 20 : 12;
    const uint64_t head = r.big_tiff ? 8 : 2;
    if (ifd + head > r.size) return false;
    uint64_t n = r.rd(d + ifd, (int)head);
    if (ifd + head + n * esz > r.size) return false;
    const uint8_t* e0 = d + ifd + head;

    auto values = [&](const uint8_t* e, std::vector<uint64_t>& out) {
        uint16_t typ = (uint16_t)r.rd(e + 2, 2);
        uint64_t cnt = r.big_tiff ? r.rd(e + 4, 8) : r.rd(e + 4, 4);
        int ts = type_size(typ);
        if (!ts) return;
        uint64_t total = cnt * ts;
        uint64_t inline_cap = r.big_tiff ? 8 : 4;
        const uint8_t* p;
        if (total <= inline_cap) {
            p = e + (r.big_tiff ? 12 : 8);
        } else {
            uint64_t off = r.big_tiff ? r.rd(e + 12, 8) : r.rd(e + 8, 4);
            if (off > r.size || total > r.size - off) return;
            p = d + off;
        }
        out.resize(cnt);
        for (uint64_t i = 0; i < cnt; ++i) out[i] = r.rd(p + i * ts, ts);
    };

    for (uint64_t i = 0; i < n; ++i) {
        const uint8_t* e = e0 + i * esz;
        uint16_t tag = (uint16_t)r.rd(e, 2);
        std::vector<uint64_t> v;
        switch (tag) {
            case 256: values(e, v); if (!v.empty()) r.width = v[0]; break;
            case 257: values(e, v); if (!v.empty()) r.height = v[0]; break;
            case 258: values(e, v); if (!v.empty()) r.bps = (uint32_t)v[0]; break;
            case 259: values(e, v); if (!v.empty()) r.compression = (uint32_t)v[0]; break;
            case 273: values(e, r.chunk_offsets); break;
            case 277: values(e, v); if (!v.empty()) r.spp = (uint32_t)v[0]; break;
            case 278: values(e, v); if (!v.empty()) r.rows_per_strip = v[0]; break;
            case 279: values(e, r.chunk_counts); break;
            case 284: values(e, v); if (!v.empty()) r.planar = (uint32_t)v[0]; break;
            case 317: values(e, v); if (!v.empty()) r.predictor = (uint32_t)v[0]; break;
            case 322: values(e, v); if (!v.empty()) r.tile_w = v[0]; break;
            case 323: values(e, v); if (!v.empty()) r.tile_h = v[0]; break;
            case 324: values(e, r.chunk_offsets); break;
            case 325: values(e, r.chunk_counts); break;
            case 339: values(e, v); if (!v.empty()) r.sample_format = (uint32_t)v[0]; break;
            default: break;
        }
    }
    if (!r.width || !r.height || !r.spp || r.chunk_offsets.empty()) return false;
    if (r.tile_w && !r.tile_h) return false;
    // a strip never holds more rows than the raster (the tag may say 2^32-1)
    if (!r.tile_w && (!r.rows_per_strip || r.rows_per_strip > r.height))
        r.rows_per_strip = r.height;
    return true;
}

// Decode one chunk into exactly dst_len bytes; false if the stream is
// refused, short or corrupt.
bool decompress(const Reader& r, const uint8_t* src, size_t src_len,
                uint8_t* dst, size_t dst_len) {
    if (r.compression == 1) {
        if (src_len < dst_len) return false;
        memcpy(dst, src, dst_len);
        return true;
    }
    if (r.compression == 8 || r.compression == 32946) {
        uLongf out_len = dst_len;
        return uncompress(dst, &out_len, src, src_len) == Z_OK
               && out_len == dst_len;
    }
    if (r.compression == 32773) {  // PackBits
        size_t si = 0, di = 0;
        while (si < src_len && di < dst_len) {
            int8_t b = (int8_t)src[si++];
            if (b >= 0) {
                size_t cnt = (size_t)b + 1;
                if (si + cnt > src_len) cnt = src_len - si;
                if (di + cnt > dst_len) cnt = dst_len - di;
                memcpy(dst + di, src + si, cnt);
                si += cnt; di += cnt;
            } else if (b != -128) {
                if (si >= src_len) break;
                size_t cnt = (size_t)(1 - b);
                if (di + cnt > dst_len) cnt = dst_len - di;
                memset(dst + di, src[si], cnt);
                ++si; di += cnt;
            }
        }
        return di == dst_len;
    }
    return false;
}

// Big-endian samples to the host's (little-endian) order.
void swap_samples(uint8_t* buf, size_t n, int bytes) {
    for (size_t i = 0; i < n; ++i) std::reverse(buf + i * bytes,
                                                buf + (i + 1) * bytes);
}

template <typename T>
void accumulate(uint8_t* row, uint64_t stride, uint32_t spp) {
    T* p = (T*)row;
    for (uint64_t i = spp; i < stride; ++i) p[i] = (T)(p[i] + p[i - spp]);
}

// Predictor 2: each sample is the difference to the one spp before it in
// its row, added as an unsigned integer of the sample's width (libtiff's
// rule, floating-point samples included).
void unpredict_rows(const Reader& r, uint8_t* buf, uint64_t rows,
                    uint64_t row_px) {
    if (r.predictor != 2) return;
    const int bytes = r.bps / 8;
    const uint64_t stride = row_px * r.spp;
    for (uint64_t y = 0; y < rows; ++y) {
        uint8_t* row = buf + y * stride * bytes;
        switch (bytes) {
            case 1: accumulate<uint8_t>(row, stride, r.spp); break;
            case 2: accumulate<uint16_t>(row, stride, r.spp); break;
            case 4: accumulate<uint32_t>(row, stride, r.spp); break;
            case 8: accumulate<uint64_t>(row, stride, r.spp); break;
        }
    }
}

}  // namespace

extern "C" {

void* tiff_open(const char* path) {
    Reader* r = new Reader();
    r->fd = open(path, O_RDONLY);
    if (r->fd < 0) { delete r; return nullptr; }
    struct stat st;
    if (fstat(r->fd, &st) != 0 || st.st_size <= 0) { delete r; return nullptr; }
    r->size = st.st_size;
    void* m = mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0);
    if (m == MAP_FAILED) { delete r; return nullptr; }
    r->data = (const uint8_t*)m;
    if (!parse(*r)) { delete r; return nullptr; }
    return r;
}

void tiff_close(void* h) { delete (Reader*)h; }

// info: [width, height, spp, bps, sample_format, compression, tiled,
//        predictor, planar, big_endian]
int tiff_info(void* h, int64_t* out) {
    Reader* r = (Reader*)h;
    if (!r) return -1;
    out[0] = (int64_t)r->width;
    out[1] = (int64_t)r->height;
    out[2] = r->spp;
    out[3] = r->bps;
    out[4] = r->sample_format;
    out[5] = r->compression;
    out[6] = r->tile_w ? 1 : 0;
    out[7] = r->predictor;
    out[8] = r->planar;
    out[9] = r->little ? 0 : 1;
    return 0;
}

// Read the window [x, x+w) x [y, y+hgt) into out (row-major, interleaved
// spp, the sample type in the host's byte order).  The area outside the
// raster is zero.  0 on success, -2 for a layout this reader refuses, -3
// for a chunk it cannot decode.
int tiff_read_window(void* h, int64_t x, int64_t y, int64_t w, int64_t hgt,
                     uint8_t* out) {
    Reader* r = (Reader*)h;
    if (!r || w < 0 || hgt < 0) return -1;
    if (r->planar != 1) return -2;
    if (r->predictor != 1 && r->predictor != 2) return -2;
    if (r->bps != 8 && r->bps != 16 && r->bps != 32 && r->bps != 64) return -2;
    const int bytes = r->bps / 8;
    const uint64_t px_sz = (uint64_t)bytes * r->spp;
    memset(out, 0, (size_t)(w * hgt * px_sz));

    const int64_t W = (int64_t)r->width, H = (int64_t)r->height;
    // the window's part inside the raster
    const int64_t wx0 = std::max<int64_t>(x, 0), wy0 = std::max<int64_t>(y, 0);
    const int64_t wx1 = std::min<int64_t>(x + w, W);
    const int64_t wy1 = std::min<int64_t>(y + hgt, H);
    if (wx0 >= wx1 || wy0 >= wy1) return 0;

    const int64_t cw = r->tile_w ? (int64_t)r->tile_w : W;
    const int64_t ch = r->tile_w ? (int64_t)r->tile_h : (int64_t)r->rows_per_strip;
    const int64_t ncx = (W + cw - 1) / cw;

    std::vector<uint8_t> buf((size_t)(cw * ch * px_sz));
    for (int64_t cy = wy0 / ch; cy <= (wy1 - 1) / ch; ++cy) {
        for (int64_t cx = wx0 / cw; cx <= (wx1 - 1) / cw; ++cx) {
            const uint64_t idx = (uint64_t)(cy * ncx + cx);
            if (idx >= r->chunk_offsets.size() || idx >= r->chunk_counts.size())
                return -3;
            const uint64_t off = r->chunk_offsets[idx];
            const uint64_t cnt = r->chunk_counts[idx];
            if (off > r->size || cnt > r->size - off) return -3;
            // a strip holds only its own rows; a tile is always whole
            const int64_t gy0 = cy * ch, gx0 = cx * cw;
            const int64_t rows = r->tile_w ? ch : std::min(ch, H - gy0);
            const size_t want = (size_t)(rows * cw * px_sz);
            if (!decompress(*r, r->data + off, cnt, buf.data(), want))
                return -3;
            if (!r->little && bytes > 1)
                swap_samples(buf.data(), (size_t)(rows * cw * r->spp), bytes);
            unpredict_rows(*r, buf.data(), rows, cw);

            // the chunk's part of the window, inside the raster
            const int64_t iy0 = std::max(wy0, gy0);
            const int64_t iy1 = std::min(wy1, gy0 + rows);
            const int64_t ix0 = std::max(wx0, gx0);
            const int64_t ix1 = std::min(wx1, gx0 + cw);
            for (int64_t yy = iy0; yy < iy1; ++yy) {
                const uint8_t* srow = buf.data()
                    + ((yy - gy0) * cw + (ix0 - gx0)) * px_sz;
                uint8_t* drow = out + ((yy - y) * w + (ix0 - x)) * px_sz;
                memcpy(drow, srow, (size_t)((ix1 - ix0) * px_sz));
            }
        }
    }
    return 0;
}

}  // extern "C"
