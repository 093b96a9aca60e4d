"""IRGAN: a generator-discriminator minimax over matrix factorization
(counterpart of ``acf_tpu/models/irgan.py``; reference IRGAN.py:9-273).

The generator G samples "fake" items from its full-catalog dot-product
softmax; the discriminator D trains with sigmoid cross-entropy on
(positive, G-sampled) items, or with ``pairwise_d`` (DIS2, IRGAN.py:58-68,
277-343) on the element-wise softplus of (positive − sampled); G trains by
policy gradient with the reward ``2(σ(D(u, i)) − 0.5)`` weighted by
``p/pn``, where pn mixes λ = 0.2 of the user's positives into G's
distribution (IRGAN.py:81-110). Both players are ``{"P", "Q"}`` initialised
U(±0.05) and trained by SGD(0.001); evaluation ranks with the generator,
through K1 on the GPU.

An epoch (:meth:`IRGAN.make_epoch_fn`) keeps the reference's phase order:
every D step over the epoch's batches with G fixed at the epoch's start,
then every G step against the new D. Each pair brings one D negative, drawn
by Gumbel-max from G's softmax at temperature 0.2, and two G samples from
the mixture pn: per sample a Bernoulli(λ) choice between a Gumbel-max draw
from G's distribution and a uniform position of the user's history. The
pad item 0 gets no mass: its logit is −1e30 in G's softmax. The draws are
plain PyTorch on the device, one [B, I] product of G a step (and the
[B, 2, I] noise of the G step); the JAX package has no kernel here either.

Under a mesh (``make_epoch_fn(..., mesh=)`` on the data-parallel copy)
every rank draws the global batch and all of its noise, takes its data
rank's rows, and sums each player's gradient over the data ranks before the
update. D's loss is a sum whose regularizer is weighted by the global batch
(``lamda_d / B`` and the 2B rows of the reference's broadcast), so the
ranks' shares sum to one device's; G's mean is a share.
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.apl import gumbel
from acf_tpu_torch.models.base import PairwiseModel, softplus
from acf_tpu_torch.sampling.negatives import sample_pair_epoch
from acf_tpu_torch.train.optim import grad_update, player, sgd, whole
from acf_tpu_torch.train.trainer import _add_stats, _data_parallel, _mean_stats

PAD_LOGIT = -1e30
NOISE_FLOOR = 1e-20  # the least uniform drawn for Gumbel noise
G_SAMPLES = 2  # G samples a pair (the reference: 2|pos| a user)


def uniforms(generator, shape):
    """Uniforms in [1e-20, 1) on the generator's device, as
    ``jax.random.uniform(minval=1e-20)`` draws them. APL's :func:`gumbel` of
    them is the JAX package's −log(−log u) bit for bit except at the floor
    itself, whose + 1e-20 doubles u (a noise of −3.81 for −3.83)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u.clamp_(min=NOISE_FLOOR)


def g_row_logits(g_params, users):
    """[B, I] logits of G's softmax for ``users``: the reference's softmax
    spans the real items only (IRGAN.py:186-192), so the pad column is
    −1e30 and never sampled."""
    logits = g_params["P"][users] @ g_params["Q"].T
    logits[:, 0] = PAD_LOGIT
    return logits


@dataclasses.dataclass(eq=False)
class IRGAN(PairwiseModel):
    init_delta: float = 0.05
    d_lr: float = 0.001
    g_lr: float = 0.001
    temperature: float = 0.2      # D-negative sampling (IRGAN.py:118)
    sample_lambda: float = 0.2    # pn's mixture weight (IRGAN.py:83)
    lamda_d: float = 0.1          # / batch_size at run time (IRGAN.py:20)
    lamda_g: float = 0.0
    pairwise_d: bool = False      # DIS2 (IRGAN.py:58-68, 277-343)

    # the positive mixture and the importance density read the whole
    # history: the trainer must not truncate it with membership_len
    uses_full_hist = True
    repr_reads_table = False  # the user representation is G's P row

    def init_params(self, generator: torch.Generator, device=None):
        dev = resolve_device(device)

        def uniform(shape):
            x = torch.empty(shape, dtype=torch.float32, device=generator.device)
            return x.uniform_(-self.init_delta, self.init_delta, generator=generator).to(dev)

        shape_u, shape_i = (self.num_users, self.dim), (self.num_items, self.dim)
        return {"g": {"P": uniform(shape_u), "Q": uniform(shape_i)},
                "d": {"P": uniform(shape_u), "Q": uniform(shape_i)}}

    def init_opt_state(self, optimizer, params):
        # the reference ignores the trainer's optimizer: both players SGD
        return {"g": sgd(self.g_lr).init(params["g"]), "d": sgd(self.d_lr).init(params["d"])}

    def opt_state_rows(self, optimizer, rows):
        """Where each leaf of :meth:`init_opt_state` lives (the
        optimizers' ``state_rows``)."""
        return {"g": sgd(self.g_lr).state_rows(rows["g"]),
                "d": sgd(self.d_lr).state_rows(rows["d"])}

    # -- scoring: evaluation ranks with the generator (IRGAN.py:36-39) --------
    def score_all(self, params, users, hists):
        return params["g"]["P"][users] @ params["g"]["Q"].T

    def score_some(self, params, users, hists, items):
        return torch.einsum("bd,bmd->bm", params["g"]["P"][users], params["g"]["Q"][items])

    def factored_scorer(self):
        if not hasattr(self, "_fs"):
            def user_repr(params, users, hists):
                return params["g"]["P"][users]

            def table(params):
                return params["g"]["Q"], None

            self._fs = (user_repr, table)
        return self._fs

    def loss(self, params, batch, generator=None):
        """The generator's BPR proxy, for reporting: mean softplus(−(s+ −
        s−)); aux ``loss`` and ``acc``."""
        users, pos, neg = batch
        g = params["g"]
        ps = torch.sum(g["P"][users] * g["Q"][pos], dim=-1)
        ns = torch.sum(g["P"][users] * g["Q"][neg], dim=-1)
        loss = self.data_share(torch.mean(softplus(-(ps - ns))))
        return loss, {"loss": loss,
                      "acc": self.data_share(torch.mean((ps > ns).to(torch.float32)))}

    # -- the players' losses --------------------------------------------------
    def d_loss(self, d_params, users, pos, fake, lam_d):
        """D's loss on one batch: sigmoid CE of (u, pos) labelled 1 and (u,
        fake) labelled 0, SUMMED, plus 2B times the L2 reg (the reference's
        [B] loss vector with the scalar reg broadcast onto it, whose sum
        minimize() differentiates, IRGAN.py:250-256; under a mesh the 2B of
        the global batch); with ``pairwise_d`` the sum of softplus(−pu ∘
        (q_pos − q_fake)) per coordinate (IRGAN.py:318-326)."""
        if self.pairwise_d:
            diff = d_params["P"][users] * (d_params["Q"][pos] - d_params["Q"][fake])
            return torch.sum(softplus(-diff))
        users2 = torch.cat([users, users])
        items2 = torch.cat([pos, fake])
        labels = torch.cat([torch.ones_like(users, dtype=torch.float32),
                            torch.zeros_like(users, dtype=torch.float32)])
        pu = d_params["P"][users2]
        qi = d_params["Q"][items2]
        logits = torch.sum(pu * qi, dim=-1)
        ce = softplus(logits) - labels * logits
        reg = lam_d * (torch.sum(torch.square(pu)) / 2 + torch.sum(torch.square(qi)) / 2)
        return torch.sum(ce) + self.data_count(labels.shape[0]) * reg

    def g_loss(self, g_params, users, sample, reward, lam_g):
        """G's policy-gradient loss: −mean(log softmax[sample] · reward) +
        the L2 reg (IRGAN.py:194-198); under a mesh the mean is the rank's
        share."""
        logp = torch.log_softmax(g_row_logits(g_params, users), dim=-1)
        lp = torch.gather(logp, 1, sample)
        pu = g_params["P"][users]
        qi = g_params["Q"][sample]
        reg = lam_g * (torch.sum(torch.square(pu)) / 2 + torch.sum(torch.square(qi)) / 2)
        return -self.data_share(torch.mean(lp * reward)) + reg

    # -- the draws ------------------------------------------------------------
    @torch.no_grad()
    def d_fakes(self, g_params, users, noise_u):
        """One fake item a pair ~ softmax(G(u) / T), by Gumbel-max over the
        uniforms ``noise_u`` [B, I] (the first index on ties, as
        ``jnp.argmax``)."""
        logits = g_row_logits(g_params, users) / self.temperature
        return torch.argmax(logits + gumbel(noise_u), dim=-1)

    @torch.no_grad()
    def g_samples(self, g_params, d_params, users, hist_rows, mix, noise_u, pos_idx):
        """(samples [B, 2], rewards [B, 2]) of the G step: per sample, where
        ``mix`` [B, 2] is set, the history position ``L − 1 − (pos_idx mod
        |hist|)`` of the user's row, else a Gumbel-max draw from G's
        distribution over the uniforms ``noise_u`` [B, 2, I]; the reward
        ``2(σ(D) − 0.5) · p/pn`` with pn = (1 − λ) p + λ m / |hist|, m the
        sample's multiplicity in the history (a uniform position draws an
        item visited m times with mass λ m / |hist|)."""
        lam = self.sample_lambda
        prob = torch.softmax(g_row_logits(g_params, users), dim=-1)  # [B, I]
        hist_len = torch.clamp(torch.sum(hist_rows != 0, dim=-1, keepdim=True), min=1)
        cat = torch.argmax(torch.log(torch.clamp(prob, min=1e-20))[:, None, :]
                           + gumbel(noise_u), dim=-1)
        L = hist_rows.shape[1]
        pos_pick = torch.gather(hist_rows, 1, L - 1 - (pos_idx % hist_len)).long()
        sample = torch.where(mix, pos_pick, cat)
        p_i = torch.gather(prob, 1, sample)
        mult = torch.sum(sample[:, :, None] == hist_rows[:, None, :], dim=-1)
        pn_i = (1 - lam) * p_i + lam / hist_len * mult
        d_scores = torch.sum(d_params["P"][users][:, None, :] * d_params["Q"][sample], dim=-1)
        reward = 2.0 * (torch.sigmoid(d_scores) - 0.5)
        return sample, reward * p_i / torch.clamp(pn_i, min=1e-20)

    def d_step(self, d_params, d_state, g_params, users, pos, noise_u, reduce=None,
               optimizer=None):
        """One D step: a fake a pair from G over ``noise_u`` [B, I], then
        SGD(d_lr) (``optimizer``, sharded under sharded storage) on D's
        loss, its gradient through ``reduce`` when given (the sum over the
        data ranks); ``g_params`` whole. Returns (d_params, d_state,
        loss)."""
        fake = self.d_fakes(g_params, users, noise_u)
        lam_d = self.lamda_d / self.data_count(users.shape[0])
        d_params, d_state, loss, _ = grad_update(
            sgd(self.d_lr) if optimizer is None else optimizer, d_params, d_state,
            lambda prm: (self.d_loss(prm, users, pos, fake, lam_d), {}), reduce)
        return d_params, d_state, loss

    def g_step(self, g_params, g_state, d_params, users, hist_rows, mix, noise_u, pos_idx,
               reduce=None, optimizer=None):
        """One G step: two samples a pair and their rewards against D
        (:meth:`g_samples`, on G's leaves read whole), then SGD(g_lr)
        (``optimizer``, sharded under sharded storage) on G's
        policy-gradient loss, its gradient through ``reduce`` when given;
        ``d_params`` whole. Returns (g_params, g_state, loss)."""
        optimizer = sgd(self.g_lr) if optimizer is None else optimizer
        g_read = whole(optimizer, g_params)  # gathered once: the samples and the loss read it
        sample, reward = self.g_samples(g_read, d_params, users, hist_rows, mix, noise_u,
                                        pos_idx)
        lam_g = self.lamda_g / self.data_count(users.shape[0])
        g_params, g_state, loss, _ = grad_update(
            optimizer, g_params, g_state,
            lambda prm: (self.g_loss(prm, users, sample, reward, lam_g), {}), reduce,
            read=g_read)
        return g_params, g_state, loss

    def make_epoch_fn(self, optimizer, batch_size: int, num_batches: int, dev=None,
                      mesh=None):
        """``epoch_fn(params, opt_state, data, generator, batches=None,
        d_u=None, g_mix=None, g_u=None, g_idx=None) -> (params, opt_state,
        stats)``: every D step on the epoch's batches with G fixed, then
        every G step against the new D. ``batches`` [num_batches, B] (pair
        indices), D's uniforms ``d_u`` [num_batches, B, I], G's mixture
        choices ``g_mix`` [num_batches, B, 2] (bool), uniforms ``g_u``
        [num_batches, B, 2, I] and history draws ``g_idx`` [num_batches, B,
        2] (non-negative ints) replace the draws from ``generator`` when
        given; otherwise each step draws its own when it runs. Stats: the
        mean G ``loss``, the mean ``d_loss`` and ``acc`` 0, as the JAX epoch
        reports them. With ``mesh`` (``self`` then
        :func:`~acf_tpu_torch.models.base.data_parallel`'s copy) every draw
        is the global batch's and each step takes this data rank's rows.
        Under sharded storage each phase reads the fixed player's leaves
        gathered once."""
        b, n_items = batch_size, self.num_items
        rows, reduce = _data_parallel(mesh, b)
        opt_g = player(optimizer, "g", sgd(self.g_lr))
        opt_d = player(optimizer, "d", sgd(self.d_lr))

        def epoch_fn(params, opt_state, data, generator, batches=None, d_u=None, g_mix=None,
                     g_u=None, g_idx=None):
            def draw(given, step, fn):
                return given[step] if given is not None else fn()

            if batches is None:
                batches = sample_pair_epoch(generator, data["pairs_u"].shape[0], b, num_batches)
            steps = [(data["pairs_u"][idx], data["pairs_i"][idx]) for idx in batches]
            g_params, d_params = params["g"], params["d"]
            g_state, d_state = opt_state["g"], opt_state["d"]
            sums = {}
            g_fixed = whole(opt_g, g_params)
            for step, (u, pos) in enumerate(steps):
                noise = draw(d_u, step, lambda: uniforms(generator, (b, n_items)))
                d_params, d_state, loss = self.d_step(d_params, d_state, g_fixed, u[rows],
                                                      pos[rows], noise[rows], reduce, opt_d)
                _add_stats(sums, {"d_loss": loss})
            del g_fixed
            d_fixed = whole(opt_d, d_params)
            for step, (u, _) in enumerate(steps):
                mix = draw(g_mix, step, lambda: torch.rand(
                    (b, G_SAMPLES), generator=generator, device=generator.device)
                    < self.sample_lambda)
                noise = draw(g_u, step, lambda: uniforms(generator, (b, G_SAMPLES, n_items)))
                pos_idx = draw(g_idx, step, lambda: torch.randint(
                    0, 2 ** 31 - 1, (b, G_SAMPLES), generator=generator,
                    device=generator.device))
                u = u[rows]
                g_params, g_state, loss = self.g_step(g_params, g_state, d_fixed, u,
                                                      data["hist"][u], mix[rows], noise[rows],
                                                      pos_idx[rows], reduce, opt_g)
                _add_stats(sums, {"loss": loss})
            stats = dict(_mean_stats(sums, num_batches, mesh), acc=0.0)
            return {"g": g_params, "d": d_params}, {"g": g_state, "d": d_state}, stats

        return epoch_fn
