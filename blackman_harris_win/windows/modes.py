"""Generation-mode advisor: pick the cheapest mode that meets a floor /
exactness requirement.

The framework carries six generation modes with different contracts,
ranked here by their per-sample work (op counts from the kernels'
structure; ``utils/profiling.py`` and the ``*_flops`` helpers hold them):

  exact    bit-exact HLS CORDIC datapath          ~4.3k int ops/sample (BH-7 W=32)
  rtl      bit-exact VHDL rounding contract       same CORDIC work, dds flavor
  taylor   bit-exact TAYLOR-source contract       ROM row + interpolation (2/3-term only)
  outer    int fast mode (floor-held approx)      ~33 int ops/harmonic
  float    native f32 (floor == f64 thru 5 terms) 4 f32 ops/harmonic (BH-7: -163 dB)
  comp     compensated-f32 (hi, lo) pair          a few x float (full f64 floor)

The non-obvious rules this encodes:

- For 2/3-term windows needing a *bit-exact integer* contract, the TAYLOR
  source is itself a reference contract (src/taylor_sincos.vhd) AND does
  a small fraction of the CORDIC datapath's work — exactness does not
  force the CORDIC path there.
- Plain f32 serves every catalog window through 5 terms at full floor;
  only the 7-term contracts need the compensated pair (pure-f32 output
  physically floors at -178.6 dB at pw=16).
- The int fast mode ("outer") only wins when the consumer needs *integer*
  samples but not bit-exactness.
- In the fused window->FFT deployment the generator runs in the FFT's
  shadow, and the comp pair drops the int->f32 convert pass that the int
  modes need — standalone generation cost is not the deployment ranking.
"""

from __future__ import annotations

from dataclasses import dataclass

from .catalog import get


# deepest floor plain f32 can hold (measured: BH-7 reads -163 of -180;
# everything at or above this level matches the f64 floor exactly)
_F32_FLOOR_DB = -160.0


@dataclass(frozen=True)
class ModeChoice:
    mode: str  # exact | rtl | taylor | outer | float | comp
    rationale: str


def recommend_mode(
    name_or_coeffs,
    consumer: str = "float",
    exactness: str = "floor",
    target_db: float | None = None,
) -> ModeChoice:
    """Cheapest generation mode meeting the requirement.

    consumer:  "float" (downstream multiplies f32 frames — Welch/STFT/
               WOLA) or "int" (integer samples leave the generator, e.g.
               feeding an integer FFT core like the reference's).
    exactness: "bit-exact" (sample-for-sample reference contract) or
               "floor" (the published side-lobe floor must hold
               spectrally; samples may differ — the fast modes).
    target_db: required floor; defaults to the window's published level
               (coefficient tuples default to the -180 dB class).
    """
    if consumer not in ("float", "int"):
        raise ValueError("consumer must be 'float' or 'int'")
    if exactness not in ("bit-exact", "floor"):
        raise ValueError("exactness must be 'bit-exact' or 'floor'")

    if isinstance(name_or_coeffs, str):
        d = get(name_or_coeffs)
        n_terms = d.n_terms
        published = d.sidelobe_db
    else:
        n_terms = len(tuple(name_or_coeffs))
        published = None
    if target_db is None:
        target_db = published if published is not None else -180.0

    def choice(mode, why):
        return ModeChoice(mode, why)

    if consumer == "int":
        if exactness == "bit-exact":
            if n_terms <= 3:
                return choice(
                    "taylor",
                    "2/3-term + bit-exact: the TAYLOR-source datapath is "
                    "itself a reference contract and the blocked kernel "
                    "does a fraction of the CORDIC path's per-sample work "
                    "(kernels/taylor.py:taylor_window_range)",
                )
            return choice(
                "exact",
                "bit-exact integer contract at 4+ terms: the fused HLS "
                "CORDIC datapath (kernels/window.py; RTL rounding via "
                "rounding='rtl' ties it)",
            )
        return choice(
            "outer",
            "integer samples with a spectrally-held floor: the "
            "outer-product angle-addition fast mode "
            "(kernels/outerwin.py, floor-validated)",
        )

    # float consumer
    if exactness == "bit-exact":
        # "bit-exact" has no meaning for float output; the strictest float
        # statement is the compensated pair (exact to ~3e-10)
        return choice(
            "comp",
            "float consumer wanting the strongest accuracy statement: the "
            "compensated (hi, lo) pair carries the f64 window to ~3e-10 "
            "(kernels/compwin.py)",
        )
    if target_db >= _F32_FLOOR_DB:
        return choice(
            "float",
            f"plain f32 holds {target_db:.0f} dB (f32 floor == f64 floor "
            "through 5-term windows; kernels/floatwin.py) — the cheapest "
            "mode",
        )
    return choice(
        "comp",
        f"{target_db:.0f} dB exceeds plain f32's ~-163 dB reach: the "
        "compensated (hi, lo) pair holds the full f64 floor "
        "(kernels/compwin.py; apply as x*hi + x*lo)",
    )
