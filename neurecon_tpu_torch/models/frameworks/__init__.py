def _module(framework: str):
    if framework == "NeuS":
        from neurecon_tpu_torch.models.frameworks import neus
        return neus
    if framework == "VolSDF":
        from neurecon_tpu_torch.models.frameworks import volsdf
        return volsdf
    if framework == "UNISURF":
        raise NotImplementedError("UNISURF is not ported yet (ROADMAP Queue A, item 2)")
    raise NotImplementedError(framework)


def get_model(args, device=None, seed: int = 0):
    """Dispatch on args.model.framework (NeuS, VolSDF; UNISURF is ROADMAP
    Queue A item 8). Returns (model, render_kwargs_train, render_kwargs_test,
    render_factory)."""
    return _module(args.model.framework).get_model(args, device=device, seed=seed)


def get_ray_loss_fn(args, model, render_kwargs_train):
    """The framework's ray-batch loss: ray_loss(rb, generator=None, it=0, ...)
    -> (total, (losses, extras)); NeuS takes `d_all=`, VolSDF
    `fine_override=` and `eik_pts=`."""
    return _module(args.model.framework).make_ray_loss_fn(model, args, render_kwargs_train)


def make_trainer(args, model, render_kwargs_train):
    """The framework's loss_fn(batch, generator, it) -> (total, (losses,
    extras)) on one image batch (see `training.make_train_step`)."""
    return _module(args.model.framework).make_trainer(model, args, render_kwargs_train)


def checkpoint_render_kwargs(args, step=None):
    """Render kwargs that depend on the training step a checkpoint was saved
    at. NeuS and VolSDF have none (s and beta live in the parameters);
    UNISURF's decaying interval is ported with UNISURF (ROADMAP Queue A,
    item 8)."""
    _module(args.model.framework)
    return {}
