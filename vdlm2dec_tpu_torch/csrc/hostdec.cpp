// Native host finisher: HDLC bit-unstuff + flag scan + CRC over RS-corrected
// burst blocks.  Exact behavioural replica of the reference's blk_thread
// bit-walk (vdlm2.c:120-152) including the flag-hunt sticky-OR quirk, and of
// check_frame's CRC (vdlm2.c:39-62, residual 0xf0b8).
//
// This is the only per-frame host work (the device hands back compact burst
// records); everything upstream runs on the device.  Built as a plain shared library, bound via ctypes.
//
// API (C ABI):
//   int vdl2_deframe_block(const uint8_t* block, int nbrow, int nlbyte,
//                          uint8_t* out, int out_cap, int* frame_off,
//                          int* frame_len, int max_frames);
//     block: nbrow rows x 255 bytes (row-major).  Emits CRC-valid frames
//     (including both 0x7e flags) packed into `out`; returns frame count.
//   int vdl2_deframe_batch(...): loop over N blocks, parallel-friendly.

#include <cstdint>
#include <cstring>

namespace {

// CRC-CCITT (PPP FCS16) table, poly 0x8408 reflected — generated at load.
uint16_t crc_tab[256];
bool crc_init_done = false;

void crc_init() {
    if (crc_init_done) return;
    for (int b = 0; b < 256; b++) {
        uint16_t v = (uint16_t)b;
        for (int i = 0; i < 8; i++)
            v = (v & 1) ? (uint16_t)((v >> 1) ^ 0x8408) : (uint16_t)(v >> 1);
        crc_tab[b] = v;
    }
    crc_init_done = true;
}

inline bool frame_crc_ok(const uint8_t* f, int l) {
    if (l < 13) return false;
    uint16_t crc = 0xffff;
    for (int i = 1; i < l - 1; i++)
        crc = (uint16_t)((crc >> 8) ^ crc_tab[(crc ^ f[i]) & 0xff]);
    return crc == 0xf0b8;
}

struct Unstuffer {
    uint8_t* buf;          // frame assembly buffer
    int cap;
    int k = 0, s = 0, t = 0;
    // emitted frames
    uint8_t* out;
    int out_cap, out_used = 0;
    int* frame_off;
    int* frame_len;
    int max_frames, n_frames = 0;

    void emit(int len) {
        if (!frame_crc_ok(buf, len)) return;
        if (n_frames >= max_frames || out_used + len > out_cap) return;
        std::memcpy(out + out_used, buf, (size_t)len);
        frame_off[n_frames] = out_used;
        frame_len[n_frames] = len;
        out_used += len;
        n_frames++;
    }

    inline void push_byte(uint8_t byte) {
        if (k >= cap - 1) { k = 0; s = 0; t = 0; buf[0] = 0; }
        for (int n = 0; n < 8; n++) {
            if (byte & (1u << n)) {
                buf[k] |= (uint8_t)(1u << s);
                t++;
            } else {
                if (t == 5) { t = 0; continue; }   // stuffed zero: drop
                t = 0;
            }
            if (++s == 8) {
                s = 0;
                if (buf[k] == 0x7e) {
                    if (k == 0) {
                        buf[++k] = 0;
                    } else if (k == 1) {
                        buf[1] = 0;
                    } else {
                        emit(k + 1);
                        buf[++k] = 0;
                    }
                } else if (k > 0) {
                    buf[++k] = 0;
                }
                // k == 0 && !flag: flag hunt — byte is deliberately NOT
                // cleared (reference quirk: later bits OR into it)
            }
        }
    }
};

}  // namespace

extern "C" {

int vdl2_deframe_block(const uint8_t* block, int nbrow, int nlbyte,
                       uint8_t* out, int out_cap,
                       int* frame_off, int* frame_len, int max_frames) {
    crc_init();
    // frame assembly buffer: a burst can hold at most 8*249 unstuffed bytes
    uint8_t fbuf[8 * 249 + 8];
    fbuf[0] = 0;
    Unstuffer u;
    u.buf = fbuf;
    u.cap = (int)sizeof(fbuf);
    u.out = out;
    u.out_cap = out_cap;
    u.frame_off = frame_off;
    u.frame_len = frame_len;
    u.max_frames = max_frames;
    for (int r = 0; r < nbrow; r++) {
        int by = (r == nbrow - 1) ? nlbyte : 249;
        const uint8_t* row = block + (size_t)r * 255;
        for (int i = 0; i < by; i++) u.push_byte(row[i]);
    }
    return u.n_frames;
}

// Batch API: blocks (n, 8, 255), geometry arrays, shared output buffer.
// Returns total frames; per-block counts in block_nframes.
int vdl2_deframe_batch(const uint8_t* blocks, const int* nbrow,
                       const int* nlbyte, int n,
                       uint8_t* out, int out_cap,
                       int* frame_off, int* frame_len, int* frame_block,
                       int max_frames, int* block_nframes) {
    crc_init();
    int total = 0;
    int used = 0;
    for (int b = 0; b < n; b++) {
        int nf = vdl2_deframe_block(
            blocks + (size_t)b * 8 * 255, nbrow[b], nlbyte[b],
            out + used, out_cap - used,
            frame_off + total, frame_len + total, max_frames - total);
        for (int j = 0; j < nf; j++) {
            frame_off[total + j] += used;
            frame_block[total + j] = b;
            used += frame_len[total + j];
        }
        block_nframes[b] = nf;
        total += nf;
    }
    return total;
}

// ACARS inner CRC check + parity strip (outacars.c:222-231): returns 1 if
// the CRC over payload[0..len-2] is zero; strips bit 7 in place.
int vdl2_acars_crc_strip(uint8_t* payload, int len) {
    crc_init();
    uint16_t crc = 0;
    for (int i = 0; i < len - 1; i++) {
        crc = (uint16_t)((crc >> 8) ^ crc_tab[(crc ^ payload[i]) & 0xff]);
        payload[i] &= 0x7f;
    }
    return crc == 0;
}

}  // extern "C"
