"""Vector visualization.

Parity with reference wdbx/utils/visualization.py: dimensionality
reduction via PCA/t-SNE/UMAP (:35-100), 2D/3D scatter plots (:102-365),
cosine similarity-matrix heatmap (:367-451), and
``visualize_vectors_from_db`` pulling up to ``max_vectors`` through the
store (:453-523). Rendering uses matplotlib (plotly/dash are optional;
the reference's interactive Dash dashboard maps to the static
``save_dashboard`` multi-panel figure). PCA runs on the device as a
subspace (block power) iteration — reducing 100k×384 vectors is a
matmul workload.

Torch port of ``wdbx_tpu/utils/visualization.py``. The PCA, the
similarity heatmap and the dashboard's similarity panel run in torch on
the store's device (the CUDA device unless the store or the caller says
``"cpu"``). The PCA's start block comes from a ``torch.Generator``
seeded 0 where JAX draws from ``jax.random.PRNGKey(0)``: the two streams
differ, so the packages agree on the subspace, not on the signs or the
rotation of its basis.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

logger = logging.getLogger("wdbx_tpu_torch.utils.visualization")


def _device_pca(x: torch.Tensor, components: int = 2, iters: int = 50):
    """PCA via subspace (block power) iteration on the covariance — two
    matmuls and a QR per step on ``x``'s device, no host round trips.
    Returns ``(x_centered @ basis, basis)``, the basis (d, components)
    orthonormal."""
    x = x.to(torch.float32)
    xc = x - x.mean(dim=0, keepdim=True)
    cov = (xc.T @ xc) / x.shape[0]  # (d, d)
    gen = torch.Generator(device=x.device).manual_seed(0)
    q = torch.randn(cov.shape[0], components, generator=gen,
                    device=x.device, dtype=torch.float32)
    for _ in range(iters):
        q, _ = torch.linalg.qr(cov @ q)
    return xc @ q, q


class VectorVisualizer:
    def __init__(self, wdbx: Any | None = None, device: Any = None):
        """``device``: where the reductions run; None means the attached
        store's device, or the CUDA device without a store."""
        self.wdbx = wdbx
        self.device = device

    def _device(self) -> torch.device:
        from wdbx_tpu_torch.index.base import resolve_device

        if self.device is None and self.wdbx is not None:
            return resolve_device(self.wdbx.store.device)
        return resolve_device(self.device)

    def _cosine_sims(self, vectors: np.ndarray) -> np.ndarray:
        """Pairwise cosine similarities of ``vectors`` on the device."""
        from wdbx_tpu_torch.ops.normalize import l2_normalize

        x = l2_normalize(torch.as_tensor(
            np.asarray(vectors, np.float32), device=self._device()))
        return (x @ x.T).cpu().numpy()

    # -- reduction ---------------------------------------------------------
    def reduce(
        self,
        vectors: np.ndarray,
        method: str = "pca",
        components: int = 2,
        **kwargs: Any,
    ) -> np.ndarray:
        vectors = np.asarray(vectors, np.float32)
        if method == "pca":
            reduced, _ = _device_pca(
                torch.as_tensor(vectors, device=self._device()),
                components=components,
            )
            return reduced.cpu().numpy()
        if method == "tsne":
            from sklearn.manifold import TSNE

            perplexity = min(
                kwargs.pop("perplexity", 30), max(2, len(vectors) - 1)
            )
            return TSNE(
                n_components=components, perplexity=perplexity, **kwargs
            ).fit_transform(vectors)
        if method == "umap":
            try:
                from umap import UMAP
            except ImportError as e:
                raise ValueError(
                    "umap-learn is not installed; use method='pca' or 'tsne'"
                ) from e
            return UMAP(n_components=components, **kwargs).fit_transform(vectors)
        raise ValueError(f"unknown reduction method: {method}")

    # -- plots -------------------------------------------------------------
    def scatter_plot(
        self,
        vectors: np.ndarray,
        labels: list[str] | None = None,
        method: str = "pca",
        components: int = 2,
        title: str = "Vector space",
        output_path: str | None = None,
    ):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        reduced = self.reduce(vectors, method=method, components=components)
        fig = plt.figure(figsize=(8, 6))
        if components == 3:
            ax = fig.add_subplot(111, projection="3d")
            ax.scatter(reduced[:, 0], reduced[:, 1], reduced[:, 2], s=12)
        else:
            ax = fig.add_subplot(111)
            ax.scatter(reduced[:, 0], reduced[:, 1], s=12)
            if labels is not None:
                for (x, y), lbl in zip(reduced[:, :2], labels):
                    ax.annotate(str(lbl), (x, y), fontsize=7, alpha=0.7)
        ax.set_title(f"{title} ({method.upper()})")
        if output_path:
            fig.savefig(output_path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            return output_path
        return fig

    def similarity_matrix(
        self,
        vectors: np.ndarray,
        labels: list[str] | None = None,
        title: str = "Cosine similarity",
        output_path: str | None = None,
    ):
        """Heatmap of pairwise cosine similarities (computed on device)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sims = self._cosine_sims(vectors)
        fig, ax = plt.subplots(figsize=(7, 6))
        im = ax.imshow(sims, cmap="viridis", vmin=-1, vmax=1)
        fig.colorbar(im, ax=ax)
        if labels is not None and len(labels) <= 40:
            ax.set_xticks(range(len(labels)))
            ax.set_yticks(range(len(labels)))
            ax.set_xticklabels(labels, rotation=90, fontsize=7)
            ax.set_yticklabels(labels, fontsize=7)
        ax.set_title(title)
        if output_path:
            fig.savefig(output_path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            return output_path
        return fig

    # -- store integration -------------------------------------------------
    def _pull_vectors(
        self, max_vectors: int = 1000, filter_metadata: dict | None = None
    ) -> tuple[np.ndarray, list[str], list[dict]]:
        if self.wdbx is None:
            raise ValueError("no WDBX instance attached")
        store = self.wdbx.store
        ids, vecs, metas = [], [], []
        with store._lock:
            for registry in store.registries:
                for vid, _slot in registry.items():
                    if len(ids) >= max_vectors:
                        break
                    got = store.get(vid)
                    if got is None:
                        continue
                    vec, meta = got
                    if filter_metadata:
                        from wdbx_tpu_torch.store.filters import matches_filter

                        if not matches_filter(meta, filter_metadata):
                            continue
                    ids.append(vid)
                    vecs.append(vec)
                    metas.append(meta)
        if not vecs:
            raise ValueError("no vectors to visualize")
        return np.asarray(vecs, np.float32), ids, metas

    def visualize_vectors_from_db(
        self,
        max_vectors: int = 1000,
        method: str = "pca",
        components: int = 2,
        filter_metadata: dict | None = None,
        output_path: str | None = None,
    ):
        vectors, ids, _ = self._pull_vectors(max_vectors, filter_metadata)
        return self.scatter_plot(
            vectors,
            labels=ids if len(ids) <= 50 else None,
            method=method,
            components=components,
            output_path=output_path,
        )

    def save_dashboard(
        self, output_path: str, max_vectors: int = 500
    ) -> str:
        """Static multi-panel dashboard: PCA scatter + similarity heatmap
        + norm histogram (the reference's Dash app, sans server)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        vectors, ids, _ = self._pull_vectors(max_vectors)
        fig, axes = plt.subplots(1, 3, figsize=(18, 5))
        reduced = self.reduce(vectors, method="pca", components=2)
        axes[0].scatter(reduced[:, 0], reduced[:, 1], s=10)
        axes[0].set_title("PCA projection")
        sample = vectors[: min(len(vectors), 64)]
        axes[1].imshow(self._cosine_sims(sample), cmap="viridis", vmin=-1,
                       vmax=1)
        axes[1].set_title(f"Similarity (first {len(sample)})")
        axes[2].hist(np.linalg.norm(vectors, axis=-1), bins=30)
        axes[2].set_title("Vector norms")
        fig.suptitle(f"WDBX dashboard — {len(vectors)} vectors")
        fig.savefig(output_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return output_path

    # -- structured / interactive outputs -----------------------------------
    # Parity with the reference's plotly html/json/base64-png outputs
    # (reference wdbx/utils/visualization.py:102-365). plotly is used
    # when importable; otherwise `html` renders a dependency-free
    # interactive canvas scatter (pan/zoom/hover) and `json` emits the
    # plain plot spec, so every output format works without plotly.
    def scatter_data(
        self,
        vectors: np.ndarray,
        labels: list[str] | None = None,
        method: str = "pca",
        components: int = 2,
        title: str = "Vector space",
        color_by: list | None = None,
    ) -> dict:
        """Reduce + package points into a renderer-agnostic plot spec."""
        reduced = self.reduce(vectors, method=method, components=components)
        spec = {
            "title": title,
            "method": method,
            "components": components,
            "points": np.asarray(reduced[:, :components], float).tolist(),
            "labels": [str(x) for x in labels] if labels is not None else None,
        }
        if color_by is not None:
            cats = sorted({str(c) for c in color_by})
            spec["groups"] = [str(c) for c in color_by]
            spec["group_names"] = cats
        return spec

    def to_json(self, spec: dict) -> str:
        try:
            fig = self._plotly_figure(spec)
            return fig.to_json()
        except ImportError:
            import json as _json

            return _json.dumps(spec)

    def to_html(self, spec: dict) -> str:
        try:
            fig = self._plotly_figure(spec)
            return fig.to_html(include_plotlyjs="cdn", full_html=True)
        except ImportError:
            return self._fallback_html(spec)

    def to_base64_png(self, fig) -> str:
        """matplotlib figure -> base64 PNG string."""
        import base64
        import io

        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=120, bbox_inches="tight")
        import matplotlib.pyplot as plt

        plt.close(fig)
        return base64.b64encode(buf.getvalue()).decode("ascii")

    def scatter_html(self, vectors, labels=None, method="pca",
                     components=2, title="Vector space",
                     output_path=None) -> str:
        """Interactive scatter as a self-contained HTML string (or file
        when ``output_path`` is given)."""
        html = self.to_html(
            self.scatter_data(vectors, labels, method, components, title)
        )
        if output_path:
            with open(output_path, "w") as f:
                f.write(html)
            return output_path
        return html

    def _plotly_figure(self, spec: dict):
        import plotly.graph_objects as go  # raises ImportError if absent

        pts = np.asarray(spec["points"], float)
        text = spec.get("labels")
        if spec["components"] == 3:
            trace = go.Scatter3d(
                x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
                mode="markers", text=text,
                marker=dict(size=3),
            )
        else:
            trace = go.Scattergl(
                x=pts[:, 0], y=pts[:, 1], mode="markers", text=text,
                marker=dict(size=5),
            )
        fig = go.Figure(data=[trace])
        fig.update_layout(title=spec["title"])
        return fig

    def _fallback_html(self, spec: dict) -> str:
        """Self-contained interactive scatter: canvas + vanilla JS
        (wheel zoom, drag pan, nearest-point hover). No dependencies."""
        import html as _html
        import json as _json

        # JSON inside an inline <script> must escape "<" — a stored id/
        # metadata value containing "</script>" would otherwise close
        # the block early and execute attacker markup (stored XSS)
        payload = _json.dumps(spec).replace("<", "\\u003c")
        title = _html.escape(str(spec["title"]))
        method = _html.escape(str(spec["method"]).upper())
        return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; margin: 1rem; }}
 #plot {{ border: 1px solid #ccc; cursor: grab; }}
 #tip {{ position: absolute; background: #222; color: #fff; padding: 2px 6px;
        border-radius: 3px; font-size: 12px; pointer-events: none;
        display: none; }}
</style></head><body>
<h3>{title} <small>({method})</small></h3>
<canvas id="plot" width="900" height="600"></canvas>
<div id="tip"></div>
<script>
const SPEC = {payload};
const cv = document.getElementById("plot"), cx = cv.getContext("2d");
const tip = document.getElementById("tip");
const pts = SPEC.points, labels = SPEC.labels || [];
const groups = SPEC.groups || null;
const is3d = SPEC.components === 3 && pts.length && pts[0].length > 2;
const palette = ["#1f77b4","#ff7f0e","#2ca02c","#d62728","#9467bd",
                 "#8c564b","#e377c2","#7f7f7f","#bcbd22","#17becf"];
let yaw = 0.6, pitch = 0.35;
function proj(p) {{
  if (!is3d) return [p[0], p[1]];
  const cy = Math.cos(yaw), sn = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x = p[0] * cy + p[2] * sn;
  const z = -p[0] * sn + p[2] * cy;
  return [x, p[1] * cp - z * sp];
}}
let x0, x1, y0, y1;
if (is3d) {{
  // rotation-invariant bounds: the bounding sphere of the point cloud
  const r = Math.max(1e-9, ...pts.map(
    p => Math.hypot(p[0], p[1], p[2])));
  x0 = -r; x1 = r; y0 = -r; y1 = r;
}} else {{
  let xs = pts.map(p => p[0]), ys = pts.map(p => p[1]);
  x0 = Math.min(...xs); x1 = Math.max(...xs);
  y0 = Math.min(...ys); y1 = Math.max(...ys);
  const padf = 0.05 * Math.max(x1 - x0, y1 - y0, 1e-9);
  x0 -= padf; x1 += padf; y0 -= padf; y1 += padf;
}}
let view = {{x0, x1, y0, y1}};
function sx(x) {{ return (x - view.x0) / (view.x1 - view.x0) * cv.width; }}
function sy(y) {{ return cv.height - (y - view.y0) / (view.y1 - view.y0) * cv.height; }}
function draw() {{
  cx.clearRect(0, 0, cv.width, cv.height);
  for (let i = 0; i < pts.length; i++) {{
    cx.fillStyle = groups
      ? palette[SPEC.group_names.indexOf(groups[i]) % palette.length]
      : "#1f77b4";
    const q = proj(pts[i]);
    cx.beginPath();
    cx.arc(sx(q[0]), sy(q[1]), 3, 0, 6.3);
    cx.fill();
  }}
}}
cv.addEventListener("wheel", e => {{
  e.preventDefault();
  const f = e.deltaY > 0 ? 1.2 : 1 / 1.2;
  const mx = view.x0 + e.offsetX / cv.width * (view.x1 - view.x0);
  const my = view.y0 + (1 - e.offsetY / cv.height) * (view.y1 - view.y0);
  view = {{ x0: mx - (mx - view.x0) * f, x1: mx + (view.x1 - mx) * f,
           y0: my - (my - view.y0) * f, y1: my + (view.y1 - my) * f }};
  draw();
}});
let drag = null;
cv.addEventListener("mousedown", e => drag = [e.offsetX, e.offsetY]);
window.addEventListener("mouseup", () => drag = null);
cv.addEventListener("mousemove", e => {{
  if (drag) {{
    if (is3d) {{  // drag rotates the cloud in 3D, pans in 2D
      yaw += (e.offsetX - drag[0]) * 0.01;
      pitch += (e.offsetY - drag[1]) * 0.01;
    }} else {{
      const dx = (e.offsetX - drag[0]) / cv.width * (view.x1 - view.x0);
      const dy = (e.offsetY - drag[1]) / cv.height * (view.y1 - view.y0);
      view.x0 -= dx; view.x1 -= dx; view.y0 += dy; view.y1 += dy;
    }}
    drag = [e.offsetX, e.offsetY];
    draw();
    return;
  }}
  let best = -1, bd = 144;
  for (let i = 0; i < pts.length; i++) {{
    const q = proj(pts[i]);
    const d = (sx(q[0]) - e.offsetX) ** 2 + (sy(q[1]) - e.offsetY) ** 2;
    if (d < bd) {{ bd = d; best = i; }}
  }}
  if (best >= 0) {{
    tip.style.display = "block";
    tip.style.left = (e.pageX + 12) + "px";
    tip.style.top = (e.pageY + 12) + "px";
    tip.textContent = (labels[best] || ("#" + best)) +
      (groups ? " [" + groups[best] + "]" : "");
  }} else tip.style.display = "none";
}});
draw();
</script></body></html>"""

    def dashboard_html(
        self,
        max_vectors: int = 500,
        method: str = "pca",
        components: int = 2,
        filter_metadata: dict | None = None,
    ) -> str:
        """Live-dashboard equivalent of the reference's Dash app
        (reference wdbx/utils/visualization.py:525-818): an interactive
        HTML page built from current store contents, with the same
        control set the reference's Dash layout exposes (reduction
        method, 2D/3D components, max vectors, metadata filter —
        reference :560-680). Controls submit as query params back to
        GET /api/v1/visualize, so refresh = recompute."""
        if method not in ("pca", "tsne", "umap"):
            raise ValueError(f"unknown reduction method: {method}")
        if components not in (2, 3):
            raise ValueError("components must be 2 or 3")
        vectors, ids, metas = self._pull_vectors(max_vectors, filter_metadata)
        color_by = None
        # color by the most common metadata key, if any is shared
        keys: dict[str, int] = {}
        for m in metas:
            for key in m:
                keys[key] = keys.get(key, 0) + 1
        for key, cnt in sorted(keys.items(), key=lambda t: -t[1]):
            values = {str(m.get(key)) for m in metas}
            if cnt >= len(metas) * 0.9 and 1 < len(values) <= 10:
                color_by = [str(m.get(key)) for m in metas]
                break
        spec = self.scatter_data(
            vectors, labels=ids, method=method, components=components,
            title=f"WDBX live dashboard — {len(vectors)} vectors",
            color_by=color_by,
        )
        page = self.to_html(spec)
        controls = self._controls_html(
            method, components, max_vectors, filter_metadata
        )
        # both the plotly page and the fallback canvas page have one
        # <body>: splice the control bar in right after it
        return page.replace("<body>", "<body>\n" + controls, 1)

    @staticmethod
    def _controls_html(
        method: str, components: int, max_vectors: int,
        filter_metadata: dict | None,
    ) -> str:
        """Plain-GET control form (no JS dependencies): submitting
        re-requests the dashboard route with new query params."""
        import html as _html
        import json as _json

        filt = (
            _html.escape(_json.dumps(filter_metadata))
            if filter_metadata else ""
        )
        m_opt = "".join(
            f'<option value="{m}"{" selected" if m == method else ""}>'
            f"{label}</option>"
            for m, label in (("pca", "PCA"), ("tsne", "t-SNE"),
                             ("umap", "UMAP"))
        )
        c_opt = "".join(
            f'<option value="{c}"{" selected" if c == components else ""}>'
            f"{c}D</option>"
            for c in (2, 3)
        )
        return f"""<form id="wdbx-controls" method="get"
 style="font-family:sans-serif;margin:0 0 1rem;display:flex;gap:1rem;
        align-items:end;flex-wrap:wrap">
 <label>Method<br><select name="method">{m_opt}</select></label>
 <label>Components<br><select name="components">{c_opt}</select></label>
 <label>Max vectors<br>
  <input name="max_vectors" type="number" min="1" value="{max_vectors}"
         style="width:6rem"></label>
 <label>Filter (key=value or JSON)<br>
  <input name="filter" value="{filt}" placeholder="source=web"
         style="width:16rem"></label>
 <input type="hidden" name="format" value="html">
 <button type="submit">Update</button>
</form>"""
