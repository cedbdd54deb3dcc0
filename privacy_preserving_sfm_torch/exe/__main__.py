from privacy_preserving_sfm_torch.exe.ppsfm import main

main()
