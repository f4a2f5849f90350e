"""ReplayGain analysis — the reference algorithm of rganalysis.c
(gst-plugins-good/gst/replaygain/), itself the canonical David
Robinson / mp3gain ReplayGain implementation.

Pipeline per the spec (rganalysis.c:57-66, 640-766):
1. equal-loudness filter = 10th-order Yule-Walker IIR (+1e-10
   denormal guard per output sample) cascaded into a 2nd-order
   Butterworth high-pass, coefficients per sample rate;
2. mean square over 50 ms windows, loudness value
   100 * 10*log10(msq/2 + 1e-37) binned into a 0.01 dB histogram of
   [0, 120) dB;
3. track/album gain = PINK_REF(64.82 dB) - 95th-percentile loudness
   (accumulator_result, rganalysis.c:357-386); album accumulation is
   the histogram vector sum + peak max (accumulator_add :334).

Coefficient tables are the published ReplayGain specification
constants (equal-loudness filters for the 9 supported rates),
reproduced from rganalysis.c:133-225 as required for spec conformance.

The IIR stage is sequential over time, so it runs through scipy's C
lfilter with carried state (the denormal guard folded in as a constant
input filtered by the same denominator — linear superposition).  The
reference computes in float32; this path uses float64 throughout, so
window loudness values can differ from the C build by a fraction of a
histogram step (1e-2 dB) — the percentile result is asserted to ±0.02
dB against a scalar float64 gold in tests.

A host copy of the JAX package's ``audio/rganalysis.py`` (numpy and scipy).
"""

from __future__ import annotations

import numpy as np

RMS_WINDOW_MS = 50
RG_REFERENCE_LEVEL = 89.0           # replaygain.h:32
STEPS_PER_DB = 100
MAX_DB = 120
PINK_REF = 64.82
RMS_PERCENTILE = 95

SAMPLE_RATES = (48000, 44100, 32000, 24000, 22050, 16000, 12000, 11025,
                8000)

# rganalysis.c:133-225 — ReplayGain spec equal-loudness coefficients.
AYULE = np.array([
    [1., -3.84664617118067, 7.81501653005538, -11.34170355132042, 13.05504219327545, -12.28759895145294, 9.48293806319790, -5.87257861775999, 2.75465861874613, -0.86984376593551, 0.13919314567432],
    [1., -3.47845948550071, 6.36317777566148, -8.54751527471874, 9.47693607801280, -8.81498681370155, 6.85401540936998, -4.39470996079559, 2.19611684890774, -0.75104302451432, 0.13149317958808],
    [1., -2.37898834973084, 2.84868151156327, -2.64577170229825, 2.23697657451713, -1.67148153367602, 1.00595954808547, -0.45953458054983, 0.16378164858596, -0.05032077717131, 0.02347897407020],
    [1., -1.61273165137247, 1.07977492259970, -0.25656257754070, -0.16276719120440, -0.22638893773906, 0.39120800788284, -0.22138138954925, 0.04500235387352, 0.02005851806501, 0.00302439095741],
    [1., -1.49858979367799, 0.87350271418188, 0.12205022308084, -0.80774944671438, 0.47854794562326, -0.12453458140019, -0.04067510197014, 0.08333755284107, -0.04237348025746, 0.02977207319925],
    [1., -0.62820619233671, 0.29661783706366, -0.37256372942400, 0.00213767857124, -0.42029820170918, 0.22199650564824, 0.00613424350682, 0.06747620744683, 0.05784820375801, 0.03222754072173],
    [1., -1.04800335126349, 0.29156311971249, -0.26806001042947, 0.00819999645858, 0.45054734505008, -0.33032403314006, 0.06739368333110, -0.04784254229033, 0.01639907836189, 0.01807364323573],
    [1., -0.51035327095184, -0.31863563325245, -0.20256413484477, 0.14728154134330, 0.38952639978999, -0.23313271880868, -0.05246019024463, -0.02505961724053, 0.02442357316099, 0.01818801111503],
    [1., -0.25049871956020, -0.43193942311114, -0.03424681017675, -0.04678328784242, 0.26408300200955, 0.15113130533216, -0.17556493366449, -0.18823009262115, 0.05477720428674, 0.04704409688120],
])
BYULE = np.array([
    [0.03857599435200, -0.02160367184185, -0.00123395316851, -0.00009291677959, -0.01655260341619, 0.02161526843274, -0.02074045215285, 0.00594298065125, 0.00306428023191, 0.00012025322027, 0.00288463683916],
    [0.05418656406430, -0.02911007808948, -0.00848709379851, -0.00851165645469, -0.00834990904936, 0.02245293253339, -0.02596338512915, 0.01624864962975, -0.00240879051584, 0.00674613682247, -0.00187763777362],
    [0.15457299681924, -0.09331049056315, -0.06247880153653, 0.02163541888798, -0.05588393329856, 0.04781476674921, 0.00222312597743, 0.03174092540049, -0.01390589421898, 0.00651420667831, -0.00881362733839],
    [0.30296907319327, -0.22613988682123, -0.08587323730772, 0.03282930172664, -0.00915702933434, -0.02364141202522, -0.00584456039913, 0.06276101321749, -0.00000828086748, 0.00205861885564, -0.02950134983287],
    [0.33642304856132, -0.25572241425570, -0.11828570177555, 0.11921148675203, -0.07834489609479, -0.00469977914380, -0.00589500224440, 0.05724228140351, 0.00832043980773, -0.01635381384540, -0.01760176568150],
    [0.44915256608450, -0.14351757464547, -0.22784394429749, -0.01419140100551, 0.04078262797139, -0.12398163381748, 0.04097565135648, 0.10478503600251, -0.01863887810927, -0.03193428438915, 0.00541907748707],
    [0.56619470757641, -0.75464456939302, 0.16242137742230, 0.16744243493672, -0.18901604199609, 0.30931782841830, -0.27562961986224, 0.00647310677246, 0.08647503780351, -0.03788984554840, -0.00588215443421],
    [0.58100494960553, -0.53174909058578, -0.14289799034253, 0.17520704835522, 0.02377945217615, 0.15558449135573, -0.25344790059353, 0.01628462406333, 0.06920467763959, -0.03721611395801, -0.00749618797172],
    [0.53648789255105, -0.42163034350696, -0.00275953611929, 0.04267842219415, -0.10214864179676, 0.14590772289388, -0.02459864859345, -0.11202315195388, -0.04060034127000, 0.04788665548180, -0.02217936801134],
])
ABUTTER = np.array([
    [1., -1.97223372919527, 0.97261396931306],
    [1., -1.96977855582618, 0.97022847566350],
    [1., -1.95835380975398, 0.95920349965459],
    [1., -1.95002759149878, 0.95124613669835],
    [1., -1.94561023566527, 0.94705070426118],
    [1., -1.92783286977036, 0.93034775234268],
    [1., -1.91858953033784, 0.92177618768381],
    [1., -1.91542108074780, 0.91885558323625],
    [1., -1.88903307939452, 0.89487434461664],
])
BBUTTER = np.array([
    [0.98621192462708, -1.97242384925416, 0.98621192462708],
    [0.98500175787242, -1.97000351574484, 0.98500175787242],
    [0.97938932735214, -1.95877865470428, 0.97938932735214],
    [0.97531843204928, -1.95063686409857, 0.97531843204928],
    [0.97316523498161, -1.94633046996323, 0.97316523498161],
    [0.96454515552826, -1.92909031105652, 0.96454515552826],
    [0.96009142950541, -1.92018285901082, 0.96009142950541],
    [0.95856916599601, -1.91713833199203, 0.95856916599601],
    [0.94597685600279, -1.89195371200558, 0.94597685600279],
])


class RgAnalysisAcc:
    """Histogram + peak accumulator (rganalysis.c:74-79)."""

    def __init__(self):
        self.histogram = np.zeros(STEPS_PER_DB * MAX_DB, np.uint32)
        self.peak = 0.0

    def add(self, other: "RgAnalysisAcc"):
        self.histogram += other.histogram
        self.peak = max(self.peak, other.peak)

    def clear(self):
        self.histogram[:] = 0
        self.peak = 0.0

    def result(self):
        """-> (gain_db, peak) or None (accumulator_result :357)."""
        total = int(self.histogram.sum())
        if total == 0:
            return None
        upper = int(np.ceil(total * (1.0 - RMS_PERCENTILE / 100.0)))
        i = len(self.histogram)
        for i in range(len(self.histogram) - 1, -1, -1):
            if upper <= int(self.histogram[i]):
                break
            upper -= int(self.histogram[i])
        return PINK_REF - i / STEPS_PER_DB, self.peak


class RgAnalysisCtx:
    """Streaming analysis context (rganalysis.c:83-130).

    Samples are float in [-1, 1] per channel (the element scales int
    formats); peak tracking uses |sample|."""

    def __init__(self):
        self.track = RgAnalysisAcc()
        self.album = RgAnalysisAcc()
        self.sample_rate = 0
        self._zi_yule = None
        self._zi_butter = None
        self._zi_guard = None
        self._win_sq = 0.0
        self._win_done = 0

    def set_sample_rate(self, rate: int) -> bool:
        if rate == self.sample_rate:
            return True
        if rate not in SAMPLE_RATES:
            return False
        self.sample_rate = rate
        self._idx = SAMPLE_RATES.index(rate)
        # ceil() via +999 (rganalysis.c:470-473)
        self.window_n = (rate * RMS_WINDOW_MS + 999) // 1000
        self.reset_filters()
        return True

    def reset_filters(self):
        self._zi_yule = None
        self._zi_butter = None
        self._zi_guard = None
        self._win_sq = 0.0
        self._win_done = 0

    def _filter(self, x):
        """Equal-loudness chain with carried IIR state; the 1e-10
        denormal guard enters as a constant input filtered by the Yule
        denominator (superposition)."""
        from scipy.signal import lfilter

        ay, by = AYULE[self._idx], BYULE[self._idx]
        ab, bb = ABUTTER[self._idx], BBUTTER[self._idx]
        c = x.shape[1]
        if self._zi_yule is None:
            self._zi_yule = np.zeros((len(ay) - 1, c))
            self._zi_butter = np.zeros((len(ab) - 1, c))
            self._zi_guard = np.zeros((len(ay) - 1, c))
        step, self._zi_yule = lfilter(by, ay, x, axis=0,
                                      zi=self._zi_yule)
        guard, self._zi_guard = lfilter(
            [1e-10], ay, np.ones_like(x), axis=0, zi=self._zi_guard)
        step = step + guard
        out, self._zi_butter = lfilter(bb, ab, step, axis=0,
                                       zi=self._zi_butter)
        return out

    def analyze(self, samples: np.ndarray):
        """samples: (n, channels) float in [-1,1]; 1 or 2 channels
        (mono duplicates into both RG channels, rganalysis.c:666)."""
        if samples.ndim == 1:
            samples = samples[:, None]
        if samples.shape[1] == 1:
            samples = np.repeat(samples, 2, axis=1)
        self.track.peak = max(self.track.peak,
                              float(np.abs(samples).max(initial=0.0)))
        # internal -0dBFS reference amplitude is ±32768
        # (rg_analysis_analyze_* :530, :640)
        out = self._filter(samples.astype(np.float64) * 32768.0)
        sq = (out ** 2).sum(axis=1)     # l^2 + r^2 per sample
        n = len(sq)
        pos = 0
        while pos < n:
            take = min(n - pos, self.window_n - self._win_done)
            self._win_sq += float(sq[pos:pos + take].sum())
            self._win_done += take
            pos += take
            if self._win_done == self.window_n:
                val = STEPS_PER_DB * 10.0 * np.log10(
                    self._win_sq / self.window_n * 0.5 + 1e-37)
                ival = min(max(int(val), 0),
                           len(self.track.histogram) - 1)
                self.track.histogram[ival] += 1
                self._win_sq = 0.0
                self._win_done = 0

    def track_result(self):
        """-> (gain, peak) or None; folds into album + resets track
        (rg_analysis_track_result :772)."""
        self.album.add(self.track)
        res = self.track.result()
        self.track.clear()
        self.reset_filters()
        return res

    def album_result(self):
        res = self.album.result()
        self.album.clear()
        return res
