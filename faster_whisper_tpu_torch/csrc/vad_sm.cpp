// Silero VAD hysteresis state machine of faster_whisper_tpu_torch, a host
// (CPU) library.  The port's copy of the JAX package's native/vad_sm.cpp,
// loaded by vad.py::hysteresis_native through ops/_build.py: an exact
// transliteration of the Python loop vad.py::_hysteresis_py (behavior
// contract: reference faster_whisper/vad.py:45-183), which stays as its
// plain version (tests/test_torch_vad.py holds the two equal).
//
// Comparison widths matter: under numpy 2 (NEP 50 weak promotion) the
// Python loop's `np.float32(p) >= python_float_threshold` compares in
// FLOAT32 (the threshold rounds to f32), so the probability comparisons
// here use float.  Position/duration comparisons mix Python ints with
// floats and stay double.
//
// Built at first use by ops/_build.py with the host g++ into build/.

extern "C" long fwt_vad_hysteresis(
    const float *probs, long n,
    double threshold, double neg_threshold,
    long window,
    double min_speech_samples,
    double max_speech_samples,            // may be +inf
    double min_silence_samples,
    double min_silence_at_max_speech,
    long n_samples,
    long *out_se,                         // start,end interleaved
    long max_out) {
  long count = 0;
  bool triggered = false;
  bool has_current = false;
  long cur_start = 0;
  long temp_end = 0, prev_end = 0, next_start = 0;
  const float thr_f = (float)threshold;
  const float neg_f = (float)neg_threshold;

  for (long i = 0; i < n; ++i) {
    float p = probs[i];
    long pos = window * i;

    if (p >= thr_f && temp_end) {
      temp_end = 0;
      if (next_start < prev_end) next_start = pos;
    }

    if (p >= thr_f && !triggered) {
      triggered = true;
      cur_start = pos;
      has_current = true;
      continue;
    }

    if (triggered && (double)(pos - cur_start) > max_speech_samples) {
      if (prev_end) {
        if (count < max_out) {
          out_se[2 * count] = cur_start;
          out_se[2 * count + 1] = prev_end;
          ++count;
        }
        has_current = false;
        if (next_start < prev_end) {
          triggered = false;
        } else {
          cur_start = next_start;
          has_current = true;
        }
        prev_end = next_start = temp_end = 0;
      } else {
        if (count < max_out) {
          out_se[2 * count] = cur_start;
          out_se[2 * count + 1] = pos;
          ++count;
        }
        has_current = false;
        prev_end = next_start = temp_end = 0;
        triggered = false;
        continue;
      }
    }

    if (p < neg_f && triggered) {
      if (!temp_end) temp_end = pos;
      if ((double)(pos - temp_end) > min_silence_at_max_speech)
        prev_end = temp_end;
      if ((double)(pos - temp_end) < min_silence_samples) continue;
      if ((double)(temp_end - cur_start) > min_speech_samples) {
        if (count < max_out) {
          out_se[2 * count] = cur_start;
          out_se[2 * count + 1] = temp_end;
          ++count;
        }
      }
      has_current = false;
      prev_end = next_start = temp_end = 0;
      triggered = false;
      continue;
    }
  }

  if (has_current && (double)(n_samples - cur_start) > min_speech_samples) {
    if (count < max_out) {
      out_se[2 * count] = cur_start;
      out_se[2 * count + 1] = n_samples;
      ++count;
    }
  }
  return count;
}
