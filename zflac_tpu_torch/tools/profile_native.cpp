// Stage-level profiler for the port's copy of the native scan engine
// (counterpart of tools/profile_native.cpp): compiles the indexer TU
// directly and times each phase of the production decode on a stream
// passed as argv[1]. Host only; not part of the shipped library.
//
// Build+run, from the checkout's root:
//   mkdir -p build/zflac_tpu_torch
//   g++ -O3 -march=native -std=c++20 -fwrapv \
//       -o build/zflac_tpu_torch/profile_native \
//       zflac_tpu_torch/tools/profile_native.cpp -lpthread
//   build/zflac_tpu_torch/profile_native \
//       .bench_cache/bench_4194304_16bit_4096.flac [reps]

#include "../index/native/indexer.cpp"

#include <chrono>
#include <cstdio>
#include <fstream>

using Clock = std::chrono::steady_clock;

static double now_ms() {
  return std::chrono::duration<double, std::milli>(
             Clock::now().time_since_epoch())
      .count();
}

template <typename F>
static double best_of(int reps, F&& f) {
  double best = 1e30;
  for (int i = 0; i < reps; i++) {
    double t0 = now_ms();
    f();
    double t1 = now_ms();
    if (t1 - t0 < best) best = t1 - t0;
  }
  return best;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s stream.flac [reps]\n", argv[0]);
    return 2;
  }
  int reps = argc > 2 ? std::atoi(argv[2]) : 5;
  std::ifstream f(argv[1], std::ios::binary);
  std::vector<uint8_t> data((std::istreambuf_iterator<char>(f)),
                            std::istreambuf_iterator<char>());
  std::printf("stream: %zu bytes\n", data.size());

  Plan meta{};
  {
    BitReader br{data.data(), data.size(), 0};
    parse_stream_meta(br, &meta);
  }
  uint64_t total = meta.si_total_samples * meta.si_channels;
  std::printf("samples: %llu x %u ch, %u bps\n",
              (unsigned long long)meta.si_total_samples, meta.si_channels,
              meta.si_bits_per_sample);
  auto msps = [&](double ms) { return (double)total / ms / 1e3; };

  // 1. Full production decode (parallel + MD5), the bench path.
  double t_full = best_of(reps, [&] {
    Plan p{};
    void* samples = nullptr;
    int rc = zfi_decode_parallel(data.data(), data.size(), 0, 1, &p,
                                 &samples);
    if (rc != OK) { std::fprintf(stderr, "rc=%d\n", rc); std::exit(1); }
    zfi_free_samples(samples);
    zfi_free(&p);
  });
  std::printf("full parallel decode+md5: %8.2f ms  (%7.1f Msamples/s)\n",
              t_full, msps(t_full));

  // 1b. Parallel decode without MD5.
  double t_nomd5 = best_of(reps, [&] {
    Plan p{};
    void* samples = nullptr;
    zfi_decode_parallel(data.data(), data.size(), 0, 0, &p, &samples);
    zfi_free_samples(samples);
    zfi_free(&p);
  });
  std::printf("full parallel decode    : %8.2f ms  (%7.1f Msamples/s)\n",
              t_nomd5, msps(t_nomd5));

  // 2. Single-thread fused fast decode (no MD5).
  double t_1t = best_of(reps, [&] {
    Plan p{};
    std::memcpy(&p, &meta, sizeof(Plan));
    void* samples = nullptr;
    BitReader br{data.data(), data.size(), 0};
    parse_stream_meta(br, &p);
    decode_cpu_t<int32_t, int16_t>(data.data(), data.size(), br, &p,
                                   &samples, 0, 0, /*fast=*/true);
    zfi_free_samples(samples);
  });
  std::printf("1-thread fused decode   : %8.2f ms  (%7.1f Msamples/s)\n",
              t_1t, msps(t_1t));

  // 3. Single-cursor interleave-engine decode (DecodeCursor path).
  double t_cur1 = best_of(reps, [&] {
    BitReader br{data.data(), data.size(), 0};
    Plan p{};
    parse_stream_meta(br, &p);
    std::vector<int16_t> pcm;
    pcm.reserve(total);
    std::vector<FrameInfo> frames;
    DecodeCursor<int32_t, int16_t> c;
    OutSink<int16_t> sink;  // the merge path: output into pcm
    sink.vec = &pcm;
    c.init(data.data(), data.size(), (int64_t)br.byte_pos(),
           (int64_t)data.size(), p.si_sample_rate, p.si_bits_per_sample,
           0, sink, &frames);
    run_cursors<int32_t, int16_t>(&c, 1);
  });
  std::printf("1-cursor engine decode  : %8.2f ms  (%7.1f Msamples/s)\n",
              t_cur1, msps(t_cur1));

  // 4. Rice walk only: fused residual extraction, no reconstruction.
  //    Approximated by a skim-free structural parse into rows.
  double t_res = best_of(reps, [&] {
    BitReader br{data.data(), data.size(), 0};
    Plan p{};
    parse_stream_meta(br, &p);
    std::vector<int32_t> work(65536), res;
    std::vector<int16_t> devnull;
    // Walk frames, decode residuals into work, skip reconstruction.
    SeqCtx ctx{};
    ctx.valid_total = p.si_total_samples > 0;
    ctx.expected_channels = p.si_channels;
    ctx.total_count = ctx.expected_channels * p.si_total_samples;
    uint64_t consumed = 0;
    for (;;) {
      if (ctx.valid_total && ctx.offset >= ctx.total_count) break;
      if (br.pos + 32 > br.nbits()) break;
      // header
      size_t frame_start = br.byte_pos();
      (void)frame_start;
      uint64_t hdr = br.read_u32();
      unsigned bs_code = (hdr >> 12) & 0xF;
      unsigned sr_code = (hdr >> 8) & 0xF;
      unsigned ch_code = (hdr >> 4) & 0xF;
      read_coded_number(br);
      uint32_t block_size = 0;
      if (bs_code == 6) block_size = br.read_u8() + 1;
      else if (bs_code == 7) block_size = br.read_u16() + 1;
      else block_size = (uint32_t)block_size_value(bs_code);
      int sr_entry = kSampleRateHz[sr_code];
      if (sr_entry == -1) br.read_u8();
      else if (sr_entry == -2 || sr_entry == -3) br.read_u16();
      uint32_t nch = (uint32_t)channel_count(ch_code);
      br.read_u8();  // crc8
      int side = side_channel(ch_code);
      for (uint32_t ch = 0; ch < nch; ch++) {
        br.read_bits(1);
        unsigned type_bits = (unsigned)br.read_bits(6);
        unsigned wf = (unsigned)br.read_bits(1);
        uint32_t wasted = wf ? br.read_unary() + 1 : 0;
        (void)wasted;
        uint32_t depth = p.si_bits_per_sample + ((int)ch == side ? 1 : 0)
                         - wasted;
        if (type_bits == 0) { br.read_signed(depth); continue; }
        if (type_bits == 1) {
          for (uint32_t i = 0; i < block_size; i++) br.read_signed(depth);
          continue;
        }
        uint32_t order = type_bits >= 32 ? type_bits - 31 : type_bits - 8;
        for (uint32_t i = 0; i < order; i++) br.read_signed(depth);
        if (type_bits >= 32) {
          uint32_t precision = (uint32_t)br.read_bits(4) + 1;
          br.read_bits(5);
          for (uint32_t j = 0; j < order; j++) br.read_signed(precision);
        }
        decode_residuals_into<int32_t>(br, work.data(), block_size, order);
        consumed += block_size;
      }
      br.align_byte();
      br.read_u16();
      ctx.offset += (uint64_t)block_size * nch;
      ctx.valid_total = ctx.valid_total && ctx.offset <= ctx.total_count;
      if (!ctx.valid_total) break;
    }
    (void)consumed;
  });
  std::printf("rice walk only (1t)     : %8.2f ms  (%7.1f Mcodes/s)\n",
              t_res, msps(t_res));


  // 6. Anchor phase cost (96 windows, single thread here).
  double t_anchor = best_of(reps, [&] {
    size_t first = 0;
    {
      BitReader br{data.data(), data.size(), 0};
      Plan p{};
      parse_stream_meta(br, &p);
      first = br.byte_pos();
    }
    size_t span = data.size() - first;
    const size_t M = 96;
    for (size_t m = 1; m < M; m++) {
      size_t lo = first + span * m / M;
      size_t hi = first + span * (m + 1) / M;
      find_anchor<int32_t>(data.data(), data.size(), lo, hi,
                           meta.si_sample_rate, meta.si_bits_per_sample);
    }
  });
  std::printf("anchor scan x96 (1t)    : %8.2f ms\n", t_anchor);

  // 7. Merge memcpy cost (one pass over the PCM).
  {
    std::vector<int16_t> src(total), dst(total);
    double t_copy = best_of(reps, [&] {
      std::memcpy(dst.data(), src.data(), total * sizeof(int16_t));
    });
    std::printf("merge memcpy            : %8.2f ms\n", t_copy);
  }
  // 5. MD5 only over the PCM bytes.
  Plan p2{};
  void* samples = nullptr;
  zfi_decode_parallel(data.data(), data.size(), 0, 0, &p2, &samples);
  size_t nbytes = total * ((meta.si_bits_per_sample + 7) / 8);
  double t_md5 = best_of(reps, [&] {
    MD5 md5;
    md5.update(samples, nbytes);
    uint8_t out[16];
    md5.final(out);
  });
  std::printf("md5 only                : %8.2f ms  (%7.1f MB/s)\n", t_md5,
              (double)nbytes / t_md5 / 1e3);
  zfi_free_samples(samples);
  zfi_free(&p2);
  return 0;
}
