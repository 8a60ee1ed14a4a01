def _module(framework: str):
    if framework == "NeuS":
        from neurecon_tpu_torch.models.frameworks import neus
        return neus
    if framework == "VolSDF":
        from neurecon_tpu_torch.models.frameworks import volsdf
        return volsdf
    if framework == "UNISURF":
        from neurecon_tpu_torch.models.frameworks import unisurf
        return unisurf
    raise NotImplementedError(framework)


def get_model(args, device=None, seed: int = 0):
    """Dispatch on args.model.framework (NeuS, VolSDF, UNISURF). Returns
    (model, render_kwargs_train, render_kwargs_test, render_factory)."""
    return _module(args.model.framework).get_model(args, device=device, seed=seed)


def get_ray_loss_fn(args, model, render_kwargs_train, shard=None):
    """The framework's ray-batch loss: ray_loss(rb, generator=None, it=0, ...)
    -> (total, (losses, extras)); NeuS takes `d_all=`, `u_up=` and `u_out=`,
    VolSDF `fine_override=`, `eik_pts=`, `u_fin=` and `u_out=`, UNISURF
    `surface_override=` and `uniforms=`. With a `shard`
    (`parallel.RayShard`), `rb` is this rank's block and each loss its share
    of the loss over the whole batch."""
    return _module(args.model.framework).make_ray_loss_fn(model, args, render_kwargs_train,
                                                          shard=shard)


def make_trainer(args, model, render_kwargs_train, shard=None):
    """The framework's loss_fn(batch, generator, it) -> (total, (losses,
    extras)) on one image batch (see `training.make_train_step`): every draw
    of the step at N_rays, and with a `shard` this rank's block of each."""
    return _module(args.model.framework).make_trainer(model, args, render_kwargs_train,
                                                      shard=shard)


def checkpoint_render_kwargs(args, step=None):
    """Render kwargs that depend on the training step a checkpoint was saved
    at, for the render factory: UNISURF's sampling interval at that step
    ({"interval": interval_at(args, step)}; `step` None or negative, as from
    a checkpoint without a global step, reads as the end of training).
    NeuS and VolSDF have none (s and beta live in the parameters)."""
    module = _module(args.model.framework)
    if args.model.framework != "UNISURF":
        return {}
    if step is None or step < 0:
        step = int(args.training.num_iters)
    return {"interval": module.interval_at(args, step)}
