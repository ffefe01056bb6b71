# Copied from catch_tpu/utils/pretty_print.py.
"""ASCII table rendering with multi-line cells.

Behavioral parity with reference catch/utils/pretty_print.py:7-88
(column widths from the longest line of any cell, per-row heights from
the tallest cell, left/right/center justification, optional dashed
underline below the header row).
"""

__all__ = ["table"]


def table(data, col_justify, header_underline=True):
    """Format a 2D array of (possibly multi-line) strings as a table."""
    if len(data) == 0:
        return ""

    num_cols = len(data[0])
    for row in data:
        if len(row) != num_cols:
            raise ValueError("data has inconsistent number of columns")
    if len(col_justify) != num_cols:
        raise ValueError("col_justify has incorrect number of entries")

    def cell_lines(entry):
        return str(entry).rstrip().split("\n")

    col_widths = [0] * num_cols
    for row in data:
        for j, col in enumerate(row):
            col_widths[j] = max(col_widths[j],
                                max(len(line) for line in cell_lines(col)))

    row_heights = [max(len(cell_lines(col)) for col in row) for row in data]

    out = ""
    for i, row in enumerate(data):
        for h in range(row_heights[i]):
            row_str = ""
            for j, col in enumerate(row):
                if j > 0:
                    row_str += " "
                lines = cell_lines(col)
                val = lines[h] if h < len(lines) else ""
                if col_justify[j] == "left":
                    row_str += val.ljust(col_widths[j])
                elif col_justify[j] == "right":
                    row_str += val.rjust(col_widths[j])
                elif col_justify[j] == "center":
                    row_str += val.center(col_widths[j])
                else:
                    raise ValueError(
                        "Unknown column justification at %d" % j)
            out += row_str + "\n"
        if i == 0 and header_underline:
            out += " ".join("-" * w for w in col_widths) + "\n"
    return out
