def get_model(args, device=None, seed: int = 0):
    """Dispatch on args.model.framework. Returns (model, render_kwargs_train,
    render_kwargs_test, render_factory). This slice of the port carries NeuS
    only; VolSDF is ROADMAP Queue A item 7, UNISURF item 8."""
    framework = args.model.framework
    if framework == "NeuS":
        from neurecon_tpu_torch.models.frameworks import neus
        return neus.get_model(args, device=device, seed=seed)
    if framework in ("VolSDF", "UNISURF"):
        raise NotImplementedError(
            f"{framework} is not ported yet (ROADMAP Queue A, items 7-8)")
    raise NotImplementedError(framework)


def get_ray_loss_fn(args, model, render_kwargs_train):
    """The framework's ray-batch loss: ray_loss(rb, generator=None, it=0,
    d_all=None) -> (total, (losses, extras)). NeuS only, like get_model."""
    if args.model.framework != "NeuS":
        raise NotImplementedError(
            f"{args.model.framework} is not ported yet (ROADMAP Queue A, items 7-8)")
    from neurecon_tpu_torch.models.frameworks.neus import make_ray_loss_fn
    return make_ray_loss_fn(model, args, render_kwargs_train)


def checkpoint_render_kwargs(args, step=None):
    """Render kwargs that depend on the training step a checkpoint was saved
    at. NeuS has none (s lives in the parameters); UNISURF's decaying
    interval is ported with UNISURF (ROADMAP Queue A, item 8)."""
    if args.model.framework == "UNISURF":
        raise NotImplementedError(
            "UNISURF is not ported yet (ROADMAP Queue A, item 8)")
    return {}
