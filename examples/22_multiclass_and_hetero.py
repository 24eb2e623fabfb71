"""Multiclass GP classification (Iris) + heteroscedastic GP regression.

Two SVGP variants beyond the reference's Gaussian-only GP stack:

1. Softmax SVGP on the full 3-class Iris problem (the reference's
   showcase dataset, used for its Laplace logistic fit) — C latent GPs
   sharing one kernel, trained jointly with the hyperparameters.
2. A heteroscedastic GP on data whose noise level rises with x: the
   latent log-noise GP recovers the noise profile, where a standard GP
   must smear one global sigma across the domain.

Run:  python examples/22_multiclass_and_hetero.py  (writes multiclass_hetero.png)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the suite's smoke runner (tests/test_examples.py)
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import jax
import jax.numpy as jnp
import numpy as np
from bayesianinference_tpu.data import load_iris

from bayesianinference_tpu.engines import (
    fit_svgp_heteroscedastic,
    fit_svgp_multiclass,
    predict_from_svgp_heteroscedastic,
    predict_from_svgp_multiclass,
)
from bayesianinference_tpu.ops.gp_kernels import se_kernel

# ---- 1. Iris, all three classes ----
iris = load_iris()
x = (iris.data - iris.data.mean(0)) / iris.data.std(0)
y = iris.target

fit = fit_svgp_multiclass(
    x, y, lambda th: se_kernel(th[0] ** 2, th[1]),
    [("amplitude", 0.05, 10.0), ("lengthscale", 0.1, 10.0)],
    inducing=24, steps=60 if SMOKE else 600, learning_rate=0.05,
    key=jax.random.PRNGKey(0),
)
probs, _, _ = predict_from_svgp_multiclass(fit, x, num_mc=512)
acc = float(np.mean(np.argmax(np.asarray(probs), axis=-1) == y))
print(f"Iris 3-class SVGP: training accuracy {acc:.3f}, "
      f"ELBO {float(fit.elbo):.1f}, theta {np.asarray(fit.theta).round(2)}")

# ---- 2. heteroscedastic regression ----
rng = np.random.default_rng(4)
n = 400
xr = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
f_true = np.sin(1.2 * xr[:, 0])
sd_true = 0.05 + 0.4 * (1 + np.tanh(1.5 * xr[:, 0]))
yr = f_true + sd_true * rng.normal(size=n)

hfit = fit_svgp_heteroscedastic(
    xr, yr,
    lambda th: se_kernel(th[0] ** 2, th[1]),
    lambda th: se_kernel(th[2] ** 2, th[3]),
    [("amp_f", 0.05, 10.0), ("ls_f", 0.1, 5.0),
     ("amp_g", 0.05, 5.0), ("ls_g", 0.3, 5.0)],
    inducing=24, steps=60 if SMOKE else 900, learning_rate=0.03,
    key=jax.random.PRNGKey(1),
)
xq = np.linspace(-3.2, 3.2, 161)[:, None]
mean, total_sd, noise_sd, latent_sd = predict_from_svgp_heteroscedastic(
    hfit, xq
)
corr_sd = np.corrcoef(
    np.asarray(predict_from_svgp_heteroscedastic(hfit, xr)[2]), sd_true
)[0, 1]
print(f"heteroscedastic GP: noise-profile correlation {corr_sd:.3f}, "
      f"ELBO {float(hfit.elbo):.1f}")

# ---- plot ----
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11.5, 4.2))
order = np.argsort(probs.max(axis=-1))
ax1.scatter(x[:, 2], x[:, 3], c=np.argmax(np.asarray(probs), -1),
            cmap="viridis", s=22, alpha=0.85)
mis = np.argmax(np.asarray(probs), -1) != y
ax1.scatter(x[mis, 2], x[mis, 3], facecolors="none", edgecolors="red",
            s=90, label="misclassified")
ax1.set_xlabel("petal length (std)"); ax1.set_ylabel("petal width (std)")
ax1.set_title(f"Iris softmax SVGP (accuracy {acc:.2f})"); ax1.legend()

m = np.asarray(mean)
ax2.fill_between(xq[:, 0], m - 1.645 * np.asarray(total_sd),
                 m + 1.645 * np.asarray(total_sd), alpha=0.25,
                 label="90% predictive")
ax2.plot(xq[:, 0], m, lw=1.4, label="mean")
ax2.plot(xq[:, 0], m + 1.645 * np.asarray(noise_sd), "--", lw=0.9,
         c="tab:red", label="±1.645 noise sd")
ax2.plot(xq[:, 0], m - 1.645 * np.asarray(noise_sd), "--", lw=0.9,
         c="tab:red")
ax2.scatter(xr[:, 0], yr, s=8, c="gray", alpha=0.6)
ax2.set_title("heteroscedastic GP: learned noise profile")
ax2.set_xlabel("x"); ax2.legend(fontsize=8)
fig.tight_layout()
fig.savefig(_os.path.join(_os.path.dirname(__file__),
                          "multiclass_hetero.png"), dpi=110)
print("wrote multiclass_hetero.png")
