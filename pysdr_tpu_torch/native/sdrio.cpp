// Native host runtime for pysdr_tpu: lock-free SPSC ring buffer,
// background .dat file streamer, and sample-format converters.
//
// This is the TPU-native equivalent of the reference's native base:
// SoapySDR's C++ streaming core feeding Python-side ring buffers
// (reference receiver.py:538-631 read_chunk over the C++ readStream;
// ring buffers from the external sig_proc lib; CS8/int16 conversion at
// receiver.py:614-617). Here the hot host path — file/device bytes ->
// float32 IQ pairs in a prefetch ring — runs in C++ with a reader thread,
// so the Python executive only does a single memcpy per block before
// jax.device_put.
//
// C ABI for ctypes (no pybind11 in this image). Complex samples are
// float32 interleaved re,im ("packed pairs", matching ops/cplx.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

// ---------------- SPSC lock-free ring buffer ----------------
// One producer, one consumer; capacity in complex samples.

struct Ring {
    float* buf;                 // 2*capacity floats
    size_t capacity;            // samples
    std::atomic<uint64_t> head; // written samples (producer)
    std::atomic<uint64_t> tail; // read samples (consumer)
    std::atomic<uint64_t> overflow_drops;

    explicit Ring(size_t cap)
        : capacity(cap), head(0), tail(0), overflow_drops(0) {
        buf = static_cast<float*>(std::malloc(sizeof(float) * 2 * cap));
    }
    ~Ring() { std::free(buf); }

    size_t count() const {
        return static_cast<size_t>(head.load(std::memory_order_acquire) -
                                   tail.load(std::memory_order_acquire));
    }
    size_t free_space() const { return capacity - count(); }

    // push up to n samples; returns samples accepted (drops excess —
    // the producer side never blocks, like the reference's non-blocking
    // readStream pump, utils.py:98-120)
    size_t push(const float* data, size_t n) {
        size_t space = free_space();
        if (n > space) {
            overflow_drops.fetch_add(n - space, std::memory_order_relaxed);
            n = space;
        }
        uint64_t h = head.load(std::memory_order_relaxed);
        size_t pos = static_cast<size_t>(h % capacity);
        size_t first = std::min(n, capacity - pos);
        std::memcpy(buf + 2 * pos, data, sizeof(float) * 2 * first);
        if (n > first)
            std::memcpy(buf, data + 2 * first, sizeof(float) * 2 * (n - first));
        head.store(h + n, std::memory_order_release);
        return n;
    }

    // pull up to n samples; returns samples delivered
    size_t pull(float* out, size_t n) {
        size_t avail = count();
        if (n > avail) n = avail;
        uint64_t t = tail.load(std::memory_order_relaxed);
        size_t pos = static_cast<size_t>(t % capacity);
        size_t first = std::min(n, capacity - pos);
        std::memcpy(out, buf + 2 * pos, sizeof(float) * 2 * first);
        if (n > first)
            std::memcpy(out + 2 * first, buf, sizeof(float) * 2 * (n - first));
        tail.store(t + n, std::memory_order_release);
        return n;
    }
};

// ---------------- .dat file streamer (mmap) ----------------
// Parses the pysdr-tpu v1 container (io/datfile.py): magic "PSDRTPU1",
// u32 JSON header length, JSON header with fs/fc/nchan/dtype, then raw
// samples.
//
// The first version prefetched through a ring with a reader thread and
// 200 us sleep-polls; for page-cached replay files that benched 2x
// SLOWER than numpy's frombuffer (BENCH_r02 host_source: 341 vs
// 640 Msamp/s — three copies + poll latency). This version mmaps the
// file: one pass from the page cache into the caller's buffer
// (converting on the fly for the 8/16-bit formats), MADV_SEQUENTIAL
// readahead, no thread, no polls, loop wrap handled in-copy.

struct Streamer {
    int fd = -1;
    const uint8_t* map = nullptr;
    size_t file_bytes = 0;
    size_t data_start = 0;   // bytes
    size_t pos = 0;          // bytes from data_start
    bool loop = false;
    std::atomic<bool> eof{false};
    double fs = 0.0, fc = 0.0;
    int nchan = 1;
    int dtype = 0;  // 0=complex64, 1=cs16, 2=cs8, 3=cu8

    bool open(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0 || st.st_size < 12) return false;
        file_bytes = static_cast<size_t>(st.st_size);
        void* m = mmap(nullptr, file_bytes, PROT_READ, MAP_PRIVATE, fd, 0);
        if (m == MAP_FAILED) return false;
        map = static_cast<const uint8_t*>(m);
        madvise(m, file_bytes, MADV_SEQUENTIAL);
        return parse_header();
    }

    bool parse_header() {
        if (std::memcmp(map, "PSDRTPU1", 8) != 0) return false;
        uint32_t hlen = 0;
        std::memcpy(&hlen, map + 8, 4);
        if (hlen > 65536 || 12 + hlen > file_bytes) return false;
        std::string hdr(reinterpret_cast<const char*>(map + 12), hlen);
        auto num = [&](const char* key, double dflt) {
            size_t p = hdr.find(key);
            if (p == std::string::npos) return dflt;
            p = hdr.find(':', p);
            if (p == std::string::npos) return dflt;
            return std::atof(hdr.c_str() + p + 1);
        };
        fs = num("\"fs\"", 0.0);
        fc = num("\"fc\"", 0.0);
        nchan = static_cast<int>(num("\"nchan\"", 1.0));
        if (hdr.find("\"complex64\"") != std::string::npos) dtype = 0;
        else if (hdr.find("\"int16\"") != std::string::npos) dtype = 1;
        else if (hdr.find("\"int8\"") != std::string::npos) dtype = 2;
        else if (hdr.find("\"uint8\"") != std::string::npos) dtype = 3;
        else return false;  // unknown dtype: refuse so the Python
                            // reader (which understands it) is used
        if (nchan != 1) return false;  // multi-channel taps likewise —
                            // memcpy'ing interleaved channels as one IQ
                            // stream would replay silently as garbage
        data_start = 12 + hlen;
        return true;
    }

    size_t sample_bytes() const {
        switch (dtype) {
            case 0: return 8;  // complex64
            case 1: return 4;  // interleaved int16 pairs
            default: return 2; // interleaved 8-bit pairs
        }
    }

    size_t data_bytes() const { return file_bytes - data_start; }

    // Convert `n` samples at byte offset `off` straight into out.
    void emit(float* out, size_t off, size_t n) const {
        const uint8_t* src = map + data_start + off;
        if (dtype == 0) {
            std::memcpy(out, src, 8 * n);
        } else if (dtype == 1) {
            const int16_t* in = reinterpret_cast<const int16_t*>(src);
            for (size_t i = 0; i < 2 * n; ++i)
                out[i] = in[i] * (1.0f / 32768.0f);
        } else if (dtype == 2) {
            const int8_t* in = reinterpret_cast<const int8_t*>(src);
            for (size_t i = 0; i < 2 * n; ++i)
                out[i] = in[i] * (1.0f / 128.0f);
        } else {
            const uint8_t* in = src;
            for (size_t i = 0; i < 2 * n; ++i)
                out[i] = (in[i] - 127.5f) * (1.0f / 127.5f);
        }
    }

    // Pull n samples (f32 pairs); short only at EOF (non-loop).
    size_t read(float* out, size_t n) {
        const size_t sb = sample_bytes();
        const size_t total = data_bytes() / sb;   // samples in file
        size_t done = 0;
        while (done < n) {
            size_t cur = pos / sb;
            size_t avail = total - cur;
            if (avail == 0) {
                if (!loop || total == 0) { eof.store(true); break; }
                pos = 0;
                continue;
            }
            size_t take = std::min(n - done, avail);
            emit(out + 2 * done, pos, take);
            pos += take * sb;
            done += take;
        }
        return done;
    }

    ~Streamer() {
        if (map) munmap(const_cast<uint8_t*>(map), file_bytes);
        if (fd >= 0) ::close(fd);
    }
};

// ---------------- RF wire quantizer ----------------
// float32 values -> integer wire codes in one pass (the executive's host
// upload), equal bit for bit to ops/cplx.quantize_host: x * s in
// float32, clipped to +-s, rounded half to even, narrowed. The rounding
// adds and subtracts 1.5 * 2^23 (exact for |v| < 2^22 in the default
// rounding mode) instead of a libm call, so the loop vectorizes at the
// Makefile's flags; the clip sits between the multiply and the add, so
// nothing contracts into an FMA.

template <typename T>
static void quantize_wire(const float* __restrict__ in, T* __restrict__ out,
                          size_t n, float s) {
    const float round_even = 12582912.0f;
    for (size_t i = 0; i < n; ++i) {
        float v = in[i] * s;
        v = v < -s ? -s : v;
        v = v > s ? s : v;
        out[i] = static_cast<T>(
            static_cast<int32_t>((v + round_even) - round_even));
    }
}

extern "C" {

// ---- ring buffer ----
void* psdr_rb_create(size_t capacity) { return new Ring(capacity); }
void psdr_rb_destroy(void* r) { delete static_cast<Ring*>(r); }
size_t psdr_rb_push(void* r, const float* d, size_t n) {
    return static_cast<Ring*>(r)->push(d, n);
}
size_t psdr_rb_pull(void* r, float* o, size_t n) {
    return static_cast<Ring*>(r)->pull(o, n);
}
size_t psdr_rb_count(void* r) { return static_cast<Ring*>(r)->count(); }
size_t psdr_rb_capacity(void* r) { return static_cast<Ring*>(r)->capacity; }
uint64_t psdr_rb_overflows(void* r) {
    return static_cast<Ring*>(r)->overflow_drops.load();
}

// ---- format converters (standalone; compiler autovectorizes) ----
void psdr_convert_cs16(const int16_t* in, float* out, size_t n2,
                       float scale) {
    for (size_t i = 0; i < n2; ++i) out[i] = in[i] * scale;
}
void psdr_convert_cs8(const int8_t* in, float* out, size_t n2, float scale) {
    for (size_t i = 0; i < n2; ++i) out[i] = in[i] * scale;
}
void psdr_convert_cu8(const uint8_t* in, float* out, size_t n2) {
    for (size_t i = 0; i < n2; ++i)
        out[i] = (in[i] - 127.5f) * (1.0f / 127.5f);
}

// ---- RF wire quantizers (codes of n floats, scale s) ----
void psdr_quantize_wire_i8(const float* in, int8_t* out, size_t n, float s) {
    quantize_wire(in, out, n, s);
}
void psdr_quantize_wire_i16(const float* in, int16_t* out, size_t n,
                            float s) {
    quantize_wire(in, out, n, s);
}

// ---- file streamer ----
// (ring_samples kept in the signature for ABI stability; the mmap
// streamer no longer needs a prefetch ring)
void* psdr_streamer_open(const char* path, size_t ring_samples, int loop) {
    (void)ring_samples;
    Streamer* s = new Streamer();
    if (!s->open(path)) {
        delete s;
        return nullptr;
    }
    s->loop = loop != 0;
    return s;
}
// Pull exactly n samples; returns samples delivered (short only at EOF).
size_t psdr_streamer_read(void* sp, float* out, size_t n) {
    return static_cast<Streamer*>(sp)->read(out, n);
}
size_t psdr_streamer_available(void* sp) {
    Streamer* s = static_cast<Streamer*>(sp);
    if (s->loop) return ~size_t(0);
    return (s->data_bytes() - s->pos) / s->sample_bytes();
}
double psdr_streamer_fs(void* sp) { return static_cast<Streamer*>(sp)->fs; }
double psdr_streamer_fc(void* sp) { return static_cast<Streamer*>(sp)->fc; }
int psdr_streamer_eof(void* sp) {
    return static_cast<Streamer*>(sp)->eof.load() ? 1 : 0;
}
void psdr_streamer_close(void* sp) {
    delete static_cast<Streamer*>(sp);
}

}  // extern "C"
