"""VHDL-like hardware templates — the codegen half of the RTL backend (port
of ``repro/rtl/templates.py``, text for text).

ElasticAI-Creator ships one hand-written template per supported layer and
instantiates it by substituting placeholders (port widths, ROM files,
Q-format generics), mirrored here with :class:`string.Template`: each node
kind below has an entity template; :mod:`repro_torch.rtl.emit` fills the
placeholders from the IR and writes the ``.mem`` ROM/BRAM initialization
files (two's-complement hex, ``$$readmemh`` layout) from ``fxp_to_int``
weights.

The texts are the reference's, byte for byte — the header line still names
``repro.rtl`` — so both packages emit identical artifacts for one design.
Every value substituted must be a Python or numpy integer (never a torch
tensor, whose ``str`` differs).
"""
from __future__ import annotations

from string import Template

import numpy as np

from repro_torch.quant.fixedpoint import FxpFormat


def to_hex_lines(values: np.ndarray, total_bits: int) -> str:
    """Two's-complement hex, one word per line (Vivado ``$readmemh``)."""
    width = (total_bits + 3) // 4
    mask = (1 << total_bits) - 1
    flat = np.asarray(values, dtype=np.int64).reshape(-1)
    return "\n".join(f"{int(v) & mask:0{width}x}" for v in flat)


def fmt_generic(prefix: str, fmt: FxpFormat) -> str:
    """Generic declarations for one Q-format, e.g. X_TOTAL_BITS/X_FRAC_BITS."""
    return (f"{prefix}_TOTAL_BITS : integer := {fmt.total_bits};\n"
            f"    {prefix}_FRAC_BITS  : integer := {fmt.frac_bits}")


HEADER = Template("""\
-- ${name}  (generated by repro.rtl — ElasticAI-Creator analogue)
-- design: ${design}   node: ${node}
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;
""")


def header(design: str, node: str) -> str:
    """The per-entity file header every template emission starts with."""
    return HEADER.substitute(name=node, design=design, node=node)

LINEAR = Template("""\
${header}
entity ${name} is
  generic (
    IN_FEATURES  : integer := ${in_features};
    OUT_FEATURES : integer := ${out_features};
    ${x_generic};
    ${w_generic};
    ${y_generic}
  );
  port (
    clk     : in  std_logic;
    enable  : in  std_logic;
    x       : in  std_logic_vector(${x_width}-1 downto 0);
    y       : out std_logic_vector(${y_width}-1 downto 0);
    done    : out std_logic
  );
end entity ${name};

architecture rtl of ${name} is
  -- ${macs} serial MACs on ${n_dsp} DSP slice(s); weights in ${w_mem},
  -- bias (accumulator-scale) in ${b_mem}.
  type rom_t is array (0 to ${rom_depth}-1)
    of std_logic_vector(${w_bits}-1 downto 0);
  signal w_rom : rom_t;  -- init: $$readmemh("${w_mem}")
  attribute rom_style : string;
  attribute rom_style of w_rom : signal is "block";
begin
  -- acc <= acc + signed(x_i) * signed(w_ij); y <= requant(acc + b_j)
  -- requant: round-half-even >> ${requant_shift}, saturate to Y format
end architecture rtl;
""")

LSTM_CELL = Template("""\
${header}
entity ${name} is
  generic (
    D_IN    : integer := ${d_in};
    HIDDEN  : integer := ${hidden};
    SEQ_LEN : integer := ${seq_len};
    ${x_generic};
    ${w_generic};
    ${c_generic}
  );
  port (
    clk     : in  std_logic;
    enable  : in  std_logic;
    x       : in  std_logic_vector(${x_width}-1 downto 0);
    h_out   : out std_logic_vector(${h_width}-1 downto 0);
    done    : out std_logic
  );
end entity ${name};

architecture rtl of ${name} is
  -- gate-fused weights (i|f|g|o) in BRAM, init: $$readmemh("${w_mem}")
  -- bias (accumulator-scale) init: $$readmemh("${b_mem}")
  -- ${macs} MACs/window on ${n_dsp} DSP slices; (h, c) in registers.
  component ${sigmoid_lut} is port (
    a : in std_logic_vector(${act_bits}-1 downto 0);
    q : out std_logic_vector(${act_bits}-1 downto 0));
  end component;
  component ${tanh_lut} is port (
    a : in std_logic_vector(${act_bits}-1 downto 0);
    q : out std_logic_vector(${act_bits}-1 downto 0));
  end component;
begin
  -- per step t in 0..SEQ_LEN-1:
  --   z      <= requant_act(x_t·W_x + h·W_h + b)        -- MAC pipeline
  --   i,f,g,o<= z(gate slices)
  --   c      <= requant_state(sig(f)*c + sig(i)*tanh(g)) -- DSP elementwise
  --   h      <= requant_act(sig(o)*tanh(requant_act(c)))
end architecture rtl;
""")

CONV1D = Template("""\
${header}
entity ${name} is
  generic (
    CHANNELS : integer := ${channels};
    KERNEL   : integer := ${kernel};
    STRIDE   : integer := ${stride};
    SEQ_LEN  : integer := ${seq_len};
    OUT_LEN  : integer := ${out_len};
    ${x_generic};
    ${w_generic};
    ${y_generic}
  );
  port (
    clk     : in  std_logic;
    enable  : in  std_logic;
    x       : in  std_logic_vector(${x_width}-1 downto 0);
    y       : out std_logic_vector(${y_width}-1 downto 0);
    done    : out std_logic
  );
end entity ${name};

architecture rtl of ${name} is
  -- depthwise taps: ${macs} serial MACs on ${n_dsp} DSP slice(s);
  -- per-channel tap weights in ${w_mem}, bias (accumulator-scale) in ${b_mem}
  type rom_t is array (0 to ${rom_depth}-1)
    of std_logic_vector(${w_bits}-1 downto 0);
  signal w_rom : rom_t;  -- init: $$readmemh("${w_mem}")
  attribute rom_style : string;
  attribute rom_style of w_rom : signal is "block";
begin
  -- per output step t in 0..OUT_LEN-1, channel c in 0..CHANNELS-1:
  --   acc   <= b_c + sum_k signed(x(t*STRIDE+k, c)) * signed(w(k, c))
  --   y(t,c)<= requant(acc)   -- round-half-even >> ${requant_shift},
  --                           -- saturate to Y format
end architecture rtl;
""")

ACT_LUT = Template("""\
${header}
entity ${name} is
  port (
    a : in  std_logic_vector(${in_bits}-1 downto 0);
    q : out std_logic_vector(${out_bits}-1 downto 0)
  );
end entity ${name};

architecture rtl of ${name} is
  -- ${kind}: ${depth}-word distributed ROM, init: $$readmemh("${mem}")
  -- address = offset-binary(a) = a + ${offset}
  type lut_t is array (0 to ${depth}-1)
    of std_logic_vector(${out_bits}-1 downto 0);
  signal lut : lut_t;
begin
  -- q <= lut(to_integer(unsigned(a xor sign_flip)));
end architecture rtl;
""")

NETWORK = Template("""\
${header}
entity ${name} is
  port (
    clk    : in  std_logic;
    enable : in  std_logic;
    x      : in  std_logic_vector(${x_width}-1 downto 0);
    y      : out std_logic_vector(${y_width}-1 downto 0);
    done   : out std_logic
  );
end entity ${name};

architecture rtl of ${name} is
${signals}
begin
${instances}
end architecture rtl;
""")

INSTANCE = Template("""\
  ${label} : entity work.${entity}
    port map (clk => clk, enable => ${enable},
              ${port_in} => ${wire_in}, ${port_out} => ${wire_out},
              done => ${done});
""")

LUT_INSTANCE = Template("""\
  ${label} : entity work.${entity}
    port map (a => ${wire_in}, q => ${wire_out});
""")

ELEMENTWISE = Template("""\
${header}
entity ${name} is
  generic (
    ${a_generic};
    ${b_generic};
    ${y_generic}
  );
  port (
    clk    : in  std_logic;
    enable : in  std_logic;
    a      : in  std_logic_vector(${a_width}-1 downto 0);
    b      : in  std_logic_vector(${b_width}-1 downto 0);
    y      : out std_logic_vector(${y_width}-1 downto 0);
    done   : out std_logic
  );
end entity ${name};

architecture rtl of ${name} is
begin
  -- y <= requant(signed(a) ${op_sym} signed(b))  (one DSP slice)
end architecture rtl;
""")

EW_INSTANCE = Template("""\
  ${label} : entity work.${entity}
    port map (clk => clk, enable => ${enable}, a => ${wire_a},
              b => ${wire_b}, y => ${wire_out}, done => ${done});
""")
