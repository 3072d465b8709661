#!/usr/bin/env python
"""Extract the AV1 default-CDF normative constant tables into .npz form.

The default symbol-probability tables are specification data (AV1 spec
section 9.4 "Default CDF tables"): every conforming decoder ships the exact
same numbers (libaom av1/common/token_cdfs.h, dav1d src/tables.c, rav1d
src/cdf.rs). We parse them out of the rav1d source (the copy available in
this environment) rather than retyping thousands of constants by hand.

The stored values follow the dav1d in-memory convention used by our msac
implementation: stored[i] = (32768 - spec_cdf[i]) & 0x7fff (probability of
"symbol >= i+1"), which is what cdf0d() in src/cdf.rs:169 computes.

Output: rav1d_jax/tables/default_cdf.npz with one array per context group.
"""

import ast
import re
import sys

import numpy as np

SRC = "/root/reference/src/cdf.rs"


def parse_struct_literal(text: str, start: int):
    """Parse `FieldName { field: AlignN(cdfXd([..])), ... }` starting at the
    opening brace; returns (dict of field -> nested ints, end index)."""
    fields = {}
    i = text.index("{", start) + 1
    depth = 1
    while True:
        # next field name
        m = re.compile(r"\s*(?:pub\s+)?(r#)?(\w+)\s*:\s*").match(text, i)
        if not m:
            # maybe closing brace
            m2 = re.compile(r"\s*}\s*").match(text, i)
            if m2:
                return fields, m2.end()
            raise ValueError(f"parse error at {text[i:i+80]!r}")
        name = m.group(2)
        i = m.end()
        # value: Align*(cdf*d([ ... ])) or Align*([ ... ]) or nested struct
        m = re.compile(r"Align\d+\s*\(\s*(?:cdf\dd\s*\(\s*)?").match(text, i)
        if m:
            i = m.end()
            val, i = parse_array(text, i)
            # consume closing parens
            while text[i] in ") \n\t":
                i += 1
            fields[name] = val
            if text[i] == ",":
                i += 1
        else:
            # bare array (no Align) or nested struct literal
            if text[i] == "[":
                val, i = parse_array(text, i)
                fields[name] = val
                while text[i] in ") \n\t":
                    i += 1
                if text[i] == ",":
                    i += 1
            else:
                m3 = re.compile(r"(\w+)\s*\{").match(text, i)
                if m3:
                    val, end = parse_struct_literal(text, i)
                    fields[name] = val
                    i = end
                    if i < len(text) and text[i] == ",":
                        i += 1
                else:
                    raise ValueError(f"unknown value at {text[i:i+80]!r}")
        # check for closing brace
        m2 = re.compile(r"\s*}").match(text, i)
        if m2:
            return fields, m2.end()


def parse_array(text: str, i: int):
    """Parse a bracketed numeric array literal; returns (python list, end)."""
    assert text[i] == "["
    depth = 0
    j = i
    while True:
        if text[j] == "[":
            depth += 1
        elif text[j] == "]":
            depth -= 1
            if depth == 0:
                break
        j += 1
    lit = text[i : j + 1]
    # Strip nested cdfXd( ... ) wrappers (mixed-width sub-tables use them
    # inline); the remaining parenthesized lists are valid Python.
    lit = re.sub(r"cdf\dd\s*\(", "(", lit)
    # Unroll Rust repeat syntax `[x; N]` (innermost-first for nesting).
    rep = re.compile(r"\[([^\[\];]*);\s*(\d+)\s*\]")
    while True:
        lit2 = rep.sub(
            lambda m: "[" + ", ".join([m.group(1).strip()] * int(m.group(2))) + "]",
            lit,
        )
        if lit2 == lit:
            break
        lit = lit2
    val = ast.literal_eval(lit)
    return val, j + 1


def _shape(v):
    """Max shape of a possibly-ragged nested list."""
    if not isinstance(v, (list, tuple)):
        return ()
    subs = [_shape(x) for x in v]
    nd = max(len(s) for s in subs)
    subs = [s + (0,) * (nd - len(s)) for s in subs]
    return (len(v),) + tuple(max(s[d] for s in subs) for d in range(nd))


def _fill(arr, v, idx):
    if not isinstance(v, (list, tuple)):
        arr[idx] = v
        return
    for i, x in enumerate(v):
        _fill(arr, x, idx + (i,))


def ragged_to_array(v):
    """Zero-pad a ragged nested list to a dense uint16 array (padding zeros
    are inert: they read as terminal-CDF/counter slots)."""
    sh = _shape(v)
    arr = np.zeros(sh, dtype=np.uint16)
    _fill(arr, v, ())
    return arr


def main():
    with open(SRC) as f:
        text = f.read()

    out = {}

    # 1. CdfModeContext: av1_default_cdf
    m = re.search(r"static av1_default_cdf: CdfModeContext = CdfModeContext", text)
    fields, _ = parse_struct_literal(text, m.end())
    for k, v in fields.items():
        out[f"m.{k}"] = ragged_to_array(v)

    # 2. kf y mode
    m = re.search(
        r"static default_kf_y_mode_cdf:[^=]+= Align32\(cdf2d\(", text
    )
    v, _ = parse_array(text, text.index("[", m.end()))
    out["kfym"] = ragged_to_array(v)

    # 3. mv joint
    m = re.search(r"static default_mv_joint_cdf:[^=]+= Align8\(cdf0d\(", text)
    v, _ = parse_array(text, text.index("[", m.end()))
    out["mv_joint"] = ragged_to_array(v)

    # 4. mv component
    m = re.search(
        r"static default_mv_component_cdf: CdfMvComponent = CdfMvComponent", text
    )
    fields, _ = parse_struct_literal(text, m.end())
    for k, v in fields.items():
        out[f"mv_comp.{k}"] = ragged_to_array(v)

    # 5. coef cdfs: [CdfCoefContext; 4]
    m = re.search(
        r"static av1_default_coef_cdf: \[CdfCoefContext; 4\] = \[", text
    )
    i = m.end()
    for qcat in range(4):
        m2 = re.compile(r"\s*CdfCoefContext\s*").match(text, i)
        if not m2:
            raise ValueError(f"expected CdfCoefContext at {text[i:i+60]!r}")
        fields, i = parse_struct_literal(text, m2.end())
        for k, v in fields.items():
            out[f"coef{qcat}.{k}"] = ragged_to_array(v)
        m3 = re.compile(r"\s*,\s*").match(text, i)
        if m3:
            i = m3.end()

    # Convert spec CDF values to the dav1d storage form used by msac:
    # stored = (32768 - v) & 0x7fff  (cdf0d in src/cdf.rs:169)
    for k in out:
        out[k] = ((32768 - out[k].astype(np.int32)) & 0x7FFF).astype(np.uint16)

    np.savez_compressed("rav1d_jax/tables/default_cdf.npz", **out)
    total = sum(a.size for a in out.values())
    print(f"wrote {len(out)} tables, {total} u16 values")
    for k in sorted(out):
        print(f"  {k}: {out[k].shape}")


if __name__ == "__main__":
    main()
