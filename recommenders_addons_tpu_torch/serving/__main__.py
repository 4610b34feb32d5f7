from recommenders_addons_tpu_torch.serving.server import main

main()
