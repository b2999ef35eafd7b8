"""Table visualization (reference: ``stdlib/viz/`` — bokeh/panel notebook
widgets). The interactive bokeh dashboard is dependency-gated (bokeh is not in
this image); ``show``/``table_viz`` fall back to a live pandas snapshot that
notebooks render and re-render via :class:`pw.LiveTable`.

Carried from ``pathway_tpu/stdlib/viz/__init__.py`` with imports rewritten."""

from __future__ import annotations

from typing import Any


def show(table: Any, **kwargs: Any):
    """Display a (live) snapshot of the table. In interactive mode returns a
    :class:`pw.LiveTable` that keeps updating; otherwise computes and prints
    the current rows."""
    try:
        import bokeh  # noqa: F401

        import warnings

        warnings.warn(
            "bokeh dashboards are not wired yet; showing the LiveTable/print "
            "fallback instead",
            stacklevel=2,
        )
    except ImportError:
        pass
    from pathway_tpu_torch.internals.interactive import is_interactive_mode_enabled, live

    if is_interactive_mode_enabled():
        return live(table)
    from pathway_tpu_torch.debug import compute_and_print

    compute_and_print(table)
    return None


table_viz = show
